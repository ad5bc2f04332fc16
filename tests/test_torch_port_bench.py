"""The port's ``bench.py`` against the JAX package's root ``bench.py``, on
the CPU at N 2,000, E 20,000, 5 relations (11 slots), 64 -> 16 -> 8.

- The graph and split draws equal ``bench.py:76-88``'s, recomputed here
  from ``default_rng(0)``.
- The chained steps from the JAX parameters carried across
  (``emb_model_from_numpy``) against the JAX bench's step body
  (``apply_emb_model`` with ``backend="gather"``, ``bce_loss`` on the
  labelled rows, ``make_optimizer(0.01, 5e-5)``), 3 steps, float32: loss
  for loss within rtol 1e-5.
- The baseline loop (one pass a relation) against ``rgcn_conv`` on the
  same model: logits within 1e-5 (atol 1e-5 * max|ref|, rtol 1e-5).
- ``main()`` under ``BENCH_DEVICE=cpu`` prints one JSON line last with
  every key of ``bench.py:206-216`` and the port's, and no kernel
  launches (the plain versions run).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scaling_rgcn_training_tpu.models import heads as jheads
from scaling_rgcn_training_tpu.ops import build_rel_edges as j_build_rel_edges
from scaling_rgcn_training_tpu.train.losses import bce_loss
from scaling_rgcn_training_tpu.train.optim import make_optimizer as j_optimizer
from scaling_rgcn_training_tpu_torch import bench

SMALL = {"BENCH_NODES": "2000", "BENCH_EDGES": "20000", "BENCH_RELS": "5",
         "BENCH_DIM": "64", "BENCH_HIDDEN": "16"}
JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "compute_dtype",
            "ms_per_step", "baseline_ms_per_step", "hbm_bytes_per_step_est",
            "achieved_gbps_est")
STEPS = 3


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("BENCH_INNER", "1")
    monkeypatch.setenv("BENCH_STEPS", str(STEPS - 1))
    for name in ("BENCH_SKIP_BASELINE", "BENCH_BASELINE_MS",
                 "BENCH_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    return bench.knobs()


def _jax_draws(n, e, r):
    """``bench.py:76-88``, line for line."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)
    n_labeled = min(4096, n // 2)
    x_train = rng.choice(n, n_labeled, replace=False).astype(np.int32)
    y_train = np.asarray(jax.nn.one_hot(jnp.arange(n_labeled) % 8, 8))
    return src, dst, typ, 2 * r + 1, x_train, y_train


@pytest.mark.parametrize("n,e,r", [(2000, 20000, 5), (9000, 5000, 45)])
def test_bench_graph_equals_the_jax_draws(n, e, r):
    """At N 9,000 the split holds 4,096 rows; at 2,000 N // 2."""
    got = bench.bench_graph(n, e, r)
    ref = _jax_draws(n, e, r)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[2].max() < 2 * r and got[3] == 2 * r + 1
    assert got[4].dtype == np.int64 and got[5].dtype == np.float32


def test_bench_steps_match_the_jax_bench(small):
    k = small
    src, dst, typ, slots, x_train, y_train = _jax_draws(
        k["nodes"], k["edges"], k["rels"])
    edges = j_build_rel_edges(src, dst, typ, k["nodes"], slots,
                              pad_to_multiple=512)
    params = jheads.init_emb_model(jax.random.key(0), slots, k["hidden"], 8,
                                   k["nodes"], k["dim"])
    optimizer = j_optimizer(0.01, 5e-5)
    xt, yt = jnp.asarray(x_train), jnp.asarray(y_train)

    @jax.jit
    def step(p, s, ed):
        def loss_of(pp):
            logits = jheads.apply_emb_model(pp, ed, backend="gather")
            return bce_loss(logits[xt], yt)

        loss, grads = jax.value_and_grad(loss_of)(p)
        updates, s2 = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s2, loss

    p, state, ref = params, optimizer.init(params), []
    for _ in range(STEPS):
        p, state, loss = step(p, state, edges)
        ref.append(float(loss))
    leaves = (np.asarray(params.embedding),
              *[[np.asarray(a) for a in (l.weight, l.root, l.bias)]
                for l in (params.rgcn1, params.rgcn2)])
    t_edges, rows, targets, t_slots = bench.build(k, torch.device("cpu"))
    assert t_slots == slots and t_edges.span is not None
    res = bench.run(k, t_edges, rows, targets, t_slots, STEPS - 1,
                    params=leaves)
    np.testing.assert_allclose(res["losses"], ref, rtol=1e-5)
    assert len(res["call_ms"]) == STEPS - 1 and res["ms_per_step"] > 0


def test_baseline_loop_matches_rgcn_conv(small):
    k = small
    edges, _, _, slots = bench.build(k, torch.device("cpu"))
    model = bench.init_model(k, slots, torch.device("cpu"))
    with torch.no_grad():
        for baseline in (False, True):
            conv = bench.step_conv(edges, k, baseline)
            z = torch.relu(conv(model.embedding, model.rgcn1))
            logits = conv(z, model.rgcn2)
            if not baseline:
                ref = logits
    torch.testing.assert_close(logits, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_main_prints_the_jax_keys(small, monkeypatch, capsys, dtype):
    monkeypatch.setenv("BENCH_COMPUTE_DTYPE", dtype)
    rec = bench.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    assert set(JAX_KEYS) <= set(line)
    assert line["metric"] == \
        "rgcn_train_step_edge_traversals_per_second_per_chip"
    assert line["unit"] == "edges/s/chip"
    assert line["compute_dtype"] == ("float32" if dtype == "float32"
                                     else "bfloat16")
    assert line["value"] == pytest.approx(
        2 * 20000 / (line["ms_per_step"] / 1e3))
    assert line["device"] == "cpu" and line["peak_mib"] is None
    assert not any(line["launches_per_step"].values())
    assert line["hbm_bytes_per_step_est"] > 10 * 2000 * 64 * 4


def test_skip_baseline_and_bad_dtype(small, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_SKIP_BASELINE", "1")
    monkeypatch.setenv("BENCH_BASELINE_MS", "123.5")
    rec = bench.main()
    assert rec["baseline_ms_per_step"] == 123.5
    monkeypatch.setenv("BENCH_COMPUTE_DTYPE", "fp16")
    with pytest.raises(SystemExit, match="BENCH_COMPUTE_DTYPE='fp16' not "
                       "recognized; use float32/f32/fp32/none or "
                       "bfloat16/bf16"):
        bench.knobs()


def test_cuda_device_without_a_card_raises(small, monkeypatch):
    monkeypatch.setenv("BENCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
