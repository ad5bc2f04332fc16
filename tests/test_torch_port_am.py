"""The AM rehearsals of the port (``rehearse_am.py``, ``rehearse_am_dist.py``)
against the JAX package's ``scripts/rehearse_am.py`` and
``scripts/rehearse_am_dist.py``, on the CPU at a small shape (N 3,000, E
20,000, 5 relations -> 11 slots, d 16, hl 8, the AM shape's 11 classes).

Tolerances:

- ``rehearse_am``'s loop against the JAX script's step body (``apply_emb_model``,
  ``bce_loss``, ``make_optimizer(0.01, 5e-5)``, 3 steps from the JAX
  parameters carried across): float32 losses rtol 1e-4, as
  ``test_torch_port_train.py`` (Adam over sums in another order); with
  bfloat16 streams rtol 2e-4: both sides round x and W to bfloat16 at the
  same points and sum in float32, each in its own order (2.5e-6 apart in
  float32 and 7.6e-6 in bfloat16 at this shape), and a bfloat16 rounding
  that the other order flips moves a value by 2^-9 of itself, which Adam's
  three steps may carry into the loss.
- The traffic model against the JAX script run as a subprocess
  (``AM_STEP=0``): H, the padded and true boundary rows and the wire bytes
  equal.
- The executed 8-shard step (library exchange and #7's plain version)
  against the same loop unpartitioned: rtol 1e-4 (phase 8's criterion);
  against the JAX ``halo_rgcn_conv`` loop on the 8 virtual CPU devices of
  ``tests/conftest.py`` from the same parameters: ``1e-5 * max|ref|``, as
  ``test_torch_port_multihost.py``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scaling_rgcn_training_tpu.models import heads as jheads
from scaling_rgcn_training_tpu.ops import build_rel_edges as j_build_rel_edges
from scaling_rgcn_training_tpu.ops import init_rgcn_layer as j_init_layer
from scaling_rgcn_training_tpu.ops.rgcn_conv import RGCNLayerParams
from scaling_rgcn_training_tpu.parallel import halo as jhalo
from scaling_rgcn_training_tpu.parallel.mesh import make_mesh as j_make_mesh
from scaling_rgcn_training_tpu.train.losses import bce_loss
from scaling_rgcn_training_tpu.train.optim import make_optimizer as j_optimizer
from scaling_rgcn_training_tpu_torch import bench_shape as bs
from scaling_rgcn_training_tpu_torch import rehearse_am as ra
from scaling_rgcn_training_tpu_torch import rehearse_am_dist as rd
from scaling_rgcn_training_tpu_torch.models.heads import layer_from_numpy
from scaling_rgcn_training_tpu_torch.parallel.halo import (
    EXCHANGE_ENV, device_put_halo_edges, padded_num_nodes)
from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"AM_NODES": "3000", "AM_EDGES": "20000", "AM_RELS": "5",
         "AM_DIM": "16", "AM_HIDDEN": "8"}
STEPS = 3
CPU = torch.device("cpu")


def _params(emb, layer1, layer2):
    """``rehearse_am_dist.make_params``' triple from numpy arrays."""
    return (torch.tensor(emb), layer_from_numpy(layer1),
            layer_from_numpy(layer2))


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("AM_INNER", "1")
    monkeypatch.setenv("AM_CALLS", str(STEPS - 1))
    for name in ("AM_OUT", "AM_DIST_OUT", "AM_PLAN_CACHE",
                 "AM_DIST_PLAN_CACHE", "AM_STEP", "AM_STEP_SCALE",
                 EXCHANGE_ENV):
        monkeypatch.delenv(name, raising=False)
    return ra.knobs()


def _jax_losses(k, cd):
    """The JAX script's step body, ``STEPS`` times, on the port's draws."""
    src, dst, typ, slots, rng = ra.am_graph(k)
    rows, targets = ra.am_labels(rng, k["nodes"], bs.AM_C)
    edges = j_build_rel_edges(src, dst, typ, k["nodes"], slots,
                              pad_to_multiple=512)
    params = jheads.init_emb_model(jax.random.key(0), slots, k["hidden"],
                                   bs.AM_C, k["nodes"], k["dim"])
    optimizer = j_optimizer(0.01, 5e-5)
    x_train, y_train = jnp.asarray(rows.astype(np.int32)), jnp.asarray(targets)

    @jax.jit
    def step(p, s, ed):
        def loss_of(pp):
            logits = jheads.apply_emb_model(pp, ed, backend=None,
                                            compute_dtype=cd)
            return bce_loss(logits[x_train], y_train)

        loss, grads = jax.value_and_grad(loss_of)(p)
        updates, s2 = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s2, loss

    state, losses, p = optimizer.init(params), [], params
    for _ in range(STEPS):
        p, state, loss = step(p, state, edges)
        losses.append(float(loss))
    leaves = (np.asarray(params.embedding),
              *[[np.asarray(a) for a in (l.weight, l.root, l.bias)]
                for l in (params.rgcn1, params.rgcn2)])
    return losses, leaves


@pytest.mark.parametrize("dtype,mode,rtol", [
    ("float32", "fused", 1e-4), ("float32", "edge", 1e-4),
    ("bfloat16", "fused", 2e-4), ("bfloat16", "edge", 2e-4)])
def test_rehearse_am_loop_matches_jax_step(small, dtype, mode, rtol):
    k = small
    jcd = None if dtype == "float32" else jnp.bfloat16
    tcd = None if dtype == "float32" else torch.bfloat16
    ref, leaves = _jax_losses(k, jcd)
    edges, rows, targets, slots, _ = ra.build_edges(k, CPU)
    res = ra.run(k, CPU, edges, rows, targets, slots, tcd, mode,
                 params=leaves)
    assert len(res["losses"]) == STEPS
    np.testing.assert_allclose(res["losses"], ref, rtol=rtol)
    assert res["first_call_s"] >= 0 and len(res["call_ms"]) == STEPS - 1
    # plain versions on the CPU: no kernel launched
    assert not any(v for st in res["launches"] for v in st.values())


def test_rehearse_am_main_writes_only_with_am_out(small, tmp_path,
                                                  monkeypatch, capsys):
    """``AM_OUT`` unset: the record goes to stdout only (the JAX script
    writes ``AMSCALE_r04.json`` into the repo by default); set: the same
    record in that file."""
    amscale = os.path.join(ROOT, "AMSCALE_r04.json")
    before = os.stat(amscale).st_mtime_ns
    monkeypatch.chdir(tmp_path)
    rec = ra.main(["--device", "cpu", "--dtype", "float32"])
    assert os.listdir(tmp_path) == []
    assert os.stat(amscale).st_mtime_ns == before
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["ms_per_step"] == rec["ms_per_step"]
    assert rec["conv_mode"] == "fused" and rec["loss_finite"]
    assert rec["padded_edges"] == small["edges"]
    out = tmp_path / "am.json"
    monkeypatch.setenv("AM_OUT", str(out))
    rec = ra.main(["--device", "cpu", "--mode", "edge"])
    assert json.loads(out.read_text())["losses"] == rec["losses"]
    assert rec["conv_mode"] == "edge" and rec["compute_dtype"] == "bfloat16"


def test_rehearse_am_dist_main_writes_only_with_am_dist_out(
        small, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("AM_STEP", "0")
    monkeypatch.chdir(tmp_path)
    rec = rd.main(["--device", "cpu"])
    assert os.listdir(tmp_path) == []
    assert rec["executed_step"] is None and len(rec["traffic_model"]) == 4
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(rec))
    out = tmp_path / "dist.json"
    monkeypatch.setenv("AM_DIST_OUT", str(out))
    rd.main(["--device", "cpu"])
    assert [a["halo_rows_padded_per_peer"] for a in
            json.loads(out.read_text())["traffic_model"]] == \
        [a["halo_rows_padded_per_peer"] for a in rec["traffic_model"]]


@pytest.fixture(scope="module")
def traffic(tmp_path_factory):
    """Both packages' traffic models at the small shape: the JAX script as
    a subprocess (``AM_STEP=0``), the port's ``main`` in-process."""
    tmp = tmp_path_factory.mktemp("am_dist")
    env = dict(os.environ, JAX_PLATFORMS="cpu", AM_STEP="0", PYTHONPATH=ROOT,
               AM_DIST_OUT=str(tmp / "jax.json"),
               AM_DIST_PLAN_CACHE=str(tmp / "jax_plans"),
               SCALING_RGCN_JAX_CACHE=str(tmp / "jax_cache"), **SMALL)
    res = subprocess.run([sys.executable, "scripts/rehearse_am_dist.py"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads((tmp / "jax.json").read_text())
    saved = {k: os.environ.get(k) for k in (*SMALL, "AM_STEP",
                                             "AM_DIST_OUT",
                                             "AM_DIST_PLAN_CACHE")}
    os.environ.update(SMALL, AM_STEP="0",
                      AM_DIST_PLAN_CACHE=str(tmp / "port_plans"))
    os.environ.pop("AM_DIST_OUT", None)
    try:
        got = rd.main(["--device", "cpu"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return got, ref


@pytest.mark.parametrize("arm", range(4))
def test_traffic_arms_match_jax_script(traffic, arm):
    got, ref = traffic
    g, r = got["traffic_model"][arm], ref["traffic_model"][arm]
    assert (g["graph"], g["reorder"]) == (r["graph"], r["reorder"])
    for key in ("halo_rows_padded_per_peer", "halo_rows_padded_per_device",
                "true_boundary_rows_total", "wire_bytes_per_step_per_device"):
        assert g[key] == r[key], key
    assert got["reorder_wire_ratio"][g["graph"]] == pytest.approx(
        ref["reorder_wire_ratio"][g["graph"]], abs=5e-4)
    assert ref["plan_cache"]["cold_s"] >= 0 and got["plan_cache"]["cold_s"] > 0


@pytest.fixture(scope="module")
def step_graph():
    """The executed step's graph (the dist script's draws at the small
    shape, scale 1), its host partition over 8 shards and numpy parameters
    (JAX ``normal`` and ``init_rgcn_layer`` from keys 0, 1, 2, as the
    script draws them)."""
    k = {"nodes": 3000, "edges": 20000, "rels": 5, "dim": 16, "hidden": 8}
    rng = np.random.default_rng(0)
    typ = rd.relations(rng, k)
    for _ in range(3):   # the arms' and the plan cache's draws
        src, dst = rd.gen(rng, "uniform", k["nodes"], k["edges"])
    src, dst = rd.gen(rng, "uniform", k["nodes"], k["edges"])
    slots = 2 * k["rels"] + 1
    host = rd.partition(src, dst, typ, k["nodes"], slots)
    n_pad = host.n_per * host.num_shards
    emb = np.asarray(jax.random.normal(jax.random.key(0), (n_pad, k["dim"])))
    layers = [j_init_layer(jax.random.key(i), slots, a, b) for i, a, b in
              ((1, k["dim"], k["hidden"]), (2, k["hidden"], bs.AM_C))]
    params = (emb, *[[np.asarray(a) for a in (l.weight, l.root, l.bias)]
                     for l in layers])
    return k, src, dst, typ, slots, host, params


@pytest.fixture(scope="module")
def unpartitioned(step_graph):
    k, src, dst, typ, slots, host, params = step_graph
    conv = rd.unpartitioned_conv(src, dst, typ, padded_num_nodes(host),
                                 slots, CPU, None)
    return rd.run_loop(_params(*params), conv, CPU,
                       STEPS)["losses"]


@pytest.fixture(scope="module")
def jax_halo_losses(step_graph):
    """The JAX script's executed step (``halo_rgcn_conv`` twice with
    ``backend="gather"``, as the script on the CPU, float32, Adam 0.01)
    on 8 virtual CPU devices, from the same parameters."""
    if len(jax.devices()) < rd.S:
        pytest.skip(f"needs {rd.S} virtual JAX devices")
    k, src, dst, typ, slots, _, (emb, l1, l2) = step_graph
    jmesh = j_make_mesh(rd.S)
    he = jhalo.device_put_halo_edges(jhalo.halo_partition_edges(
        src, dst, typ, k["nodes"], slots, rd.S, pad_to_multiple=512), jmesh)
    params = (jax.device_put(jnp.asarray(emb), jhalo.node_sharding(jmesh)),
              RGCNLayerParams(*map(jnp.asarray, l1)),
              RGCNLayerParams(*map(jnp.asarray, l2)))
    count = min(bs.AM_LABELLED, emb.shape[0])
    y = jax.nn.one_hot(np.arange(count) % bs.AM_C, bs.AM_C)
    idx = jnp.arange(count)
    opt = optax.adam(0.01)
    state = opt.init(params)

    @jax.jit
    def step(ps, st):
        def loss_of(p):
            e_, a_, b_ = p
            z = jax.nn.relu(jhalo.halo_rgcn_conv(e_, he, a_, jmesh,
                                                 backend="gather"))
            logits = jhalo.halo_rgcn_conv(z, he, b_, jmesh, backend="gather")
            return bce_loss(logits[idx], y)

        loss, grads = jax.value_and_grad(loss_of)(ps)
        updates, st2 = opt.update(grads, st)
        return optax.apply_updates(ps, updates), st2, loss

    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("exchange", [None, "fused"])
def test_executed_step_matches_unpartitioned_and_jax(
        step_graph, unpartitioned, jax_halo_losses, exchange, monkeypatch):
    """The halo step over 8 virtual CPU shards (the library exchange, and
    #7's plain version) against the unpartitioned loop (rtol 1e-4) and the
    JAX halo loop (1e-5 * max|ref|)."""
    k, src, dst, typ, slots, host, params = step_graph
    if exchange is None:
        monkeypatch.delenv(EXCHANGE_ENV, raising=False)
    else:
        monkeypatch.setenv(EXCHANGE_ENV, exchange)
    mesh = make_mesh(devices=("cpu",) * rd.S)
    he = device_put_halo_edges(host, mesh)
    res = rd.run_loop(_params(*params),
                      rd.halo_conv(he, mesh, None), CPU, STEPS, mesh)
    np.testing.assert_allclose(res["losses"], unpartitioned, rtol=1e-4)
    atol = 1e-5 * max(abs(v) for v in jax_halo_losses)
    np.testing.assert_allclose(res["losses"], jax_halo_losses, rtol=0,
                               atol=atol)
    assert res["first_step_s"] >= 0 and len(res["call_ms"]) == STEPS - 1


def test_executed_step_record(small, monkeypatch):
    """``executed_step`` at half the small shape (``AM_STEP_SCALE`` 0.5):
    the record's keys, finite losses, nothing launched on the CPU."""
    k = small
    rng = np.random.default_rng(0)
    typ = rd.relations(rng, k)
    n_s, e_s = k["nodes"] // 2, k["edges"] // 2
    src, dst = rd.gen(rng, "uniform", k["nodes"], k["edges"])
    rec = rd.executed_step(src[:e_s] % n_s, dst[:e_s] % n_s, typ[:e_s], k,
                           CPU, 3, None, 0.5)
    assert rec["devices"] == rd.S and rec["nodes"] == n_s
    assert rec["edges"] == e_s and rec["exchange"] == "library"
    assert rec["loss_finite"] and len(rec["losses"]) == 3
    assert rec["peak_device_memory_mib"] is None
    assert rec["peak_host_rss_gib"] > 0
    assert not any(rec["launches"].values())


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ra.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rd.main(["--device", "cuda"])
