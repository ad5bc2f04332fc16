"""Halo training across processes: the port's 2 processes x 2 shards
against its single-process 4-shard run and against the JAX package's halo
loop, on the CPU.

``python -m scaling_rgcn_training_tpu_torch.multihost_sim`` runs the
single-process oracle, then spawns 2 processes that join a gloo group
through a ``file://`` rendezvous under the test's ``tmp_path`` (so xdist
workers never share a port), each with 2 virtual CPU shards, for the
library exchange, kernel #6 and kernel #7 (their plain versions across
processes on the CPU), at the JAX test's size (N 512, E 4096, 3 steps,
float32). Tolerances: between the port's two layouts the JAX script's
(``rtol=1e-5, atol=1e-6``: the loss and the replicated gradients are
summed in another order); against JAX the halo conv's test's float32
tolerance, ``1e-5 * max|ref|`` (other summation order). The JAX side runs
on 4 of the 8 virtual CPU devices of ``tests/conftest.py``.
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

from scaling_rgcn_training_tpu.ops.rgcn_conv import RGCNLayerParams
from scaling_rgcn_training_tpu.parallel import halo as jhalo
from scaling_rgcn_training_tpu.parallel.mesh import make_mesh as j_make_mesh
from scaling_rgcn_training_tpu.train.losses import bce_loss
from scaling_rgcn_training_tpu_torch import multihost_sim as mh
from scaling_rgcn_training_tpu_torch.parallel import mesh as tmesh
from scaling_rgcn_training_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = {"MH_NODES": "512", "MH_EDGES": "4096", "MH_STEPS": "3",
         "MH_BF16": "0", "MH_REORDER": "1", "MH_LABELLED": "128"}
MODES = ("library", "kernel", "fused")
S, PROCS = 4, 2
TIMEOUT = 240


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", **KNOBS)
    env.pop("MH_PORT", None)
    env.pop("RGCN_HALO_PALLAS_A2A", None)
    return env


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One parent run: the oracle, then 2 processes x 2 shards for every
    mode, with the cross-process kernel checks and the checkpoints."""
    tmp = tmp_path_factory.mktemp("multihost")
    ckpt = tmp / "ckpt"
    res = subprocess.run(
        [sys.executable, "-m", "scaling_rgcn_training_tpu_torch.multihost_sim",
         "--device", "cpu", "--procs", str(PROCS), "--shards-per-proc",
         str(S // PROCS), "--modes", ",".join(MODES), "--check", "--ckpt",
         str(ckpt), "--workdir", str(tmp / "work"), "--timeout",
         str(TIMEOUT - 60)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    return rec, ckpt


@pytest.fixture(scope="module")
def jax_losses():
    """The JAX package's halo loop (``halo_partition_edges``,
    ``halo_rgcn_conv`` with ``backend="gather"``, ``bce_loss``,
    ``optax.adam(0.05)``) over 4 virtual devices, on the port's graph and
    numpy-made parameters."""
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} virtual JAX devices")
    knobs = {"nodes": 512, "edges": 4096, "rels": 5, "reorder": True}
    src, dst, typ, slots = mh.make_graph(knobs, S)
    n = knobs["nodes"]
    jmesh = j_make_mesh(S)
    he = jhalo.device_put_halo_edges(jhalo.halo_partition_edges(
        src, dst, typ, n, slots, S, pad_to_multiple=64, halo_multiple=8),
        jmesh)
    emb, layers = mh.make_params(jhalo.padded_num_nodes(he), [16, 8, 4],
                                 slots)
    rows, y = mh.labels(n, 4, 128)
    params = (jax.device_put(jnp.asarray(emb), jhalo.node_sharding(jmesh)),
              *[RGCNLayerParams(*map(jnp.asarray, layer)) for layer in layers])
    opt = optax.adam(mh.LR)
    state = opt.init(params)

    def loss_of(p):
        e, a, b = p
        z = jax.nn.relu(jhalo.halo_rgcn_conv(e, he, a, jmesh,
                                             backend="gather"))
        logits = jhalo.halo_rgcn_conv(z, he, b, jmesh, backend="gather")
        return bce_loss(logits[jnp.asarray(rows)], jnp.asarray(y))

    @jax.jit
    def step(p, st):
        loss, grads = jax.value_and_grad(loss_of)(p, )
        updates, st = opt.update(grads, st)
        return optax.apply_updates(p, updates), st, loss

    losses = []
    for _ in range(3):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("mode", MODES)
def test_two_processes_match_one_process(run, mode):
    """The 2-process losses of each exchange mode against the port's
    single-process 4-shard run, at the JAX script's tolerance."""
    rec, _ = run
    m = rec["modes"][f"{mode}-f32"]
    assert rec["processes"] == PROCS and rec["global_shards"] == S
    assert rec["backend"] == "gloo"
    assert len(m["multi_process_losses"]) == 3
    np.testing.assert_allclose(m["multi_process_losses"],
                               m["single_process_losses"], rtol=1e-5,
                               atol=1e-6)
    assert m["loss_parity"] is True
    # each process launched nothing (plain versions on the CPU)
    assert all(not any(step.values()) for proc in m["launches"]
               for step in proc)


@pytest.mark.parametrize("mode", MODES)
def test_port_matches_jax_halo_loop(run, jax_losses, mode):
    """Both of the port's layouts against the JAX halo loop: float32,
    ``1e-5 * max|ref|``."""
    rec, _ = run
    m = rec["modes"][f"{mode}-f32"]
    atol = 1e-5 * max(abs(v) for v in jax_losses)
    for series in ("single_process_losses", "multi_process_losses"):
        np.testing.assert_allclose(m[series], jax_losses, rtol=0, atol=atol,
                                   err_msg=series)


def test_cross_process_exchanges_match_plain_versions(run):
    """Every process held the library exchange, #6 and #7 across processes
    against the single-process plain versions at S = 2 and 4 (a shard with
    no halo edges, a peer that ships no rows), float32 and bfloat16."""
    rec, _ = run
    assert len(rec["check"]) == PROCS
    for proc in rec["check"]:
        assert [c["shards"] for c in proc] == [2, 4]
        assert all(c["fused_err"] < 1e-3 for c in proc)


def test_two_process_checkpoint_has_the_single_process_bits(run):
    """The state before the first step, written by 2 processes (the
    embedding's rows gathered in shard order, rank 0 writing) and by one:
    the same arrays, bit for bit; the final state's file loads into either
    layout, each process taking its rows."""
    rec, ckpt = run
    assert rec["ckpt_step0_bits_equal"] is True
    single, _ = load_checkpoint(str(ckpt / "single-library-f32-step0"))
    multi, _ = load_checkpoint(str(ckpt / "multi-library-f32-step0"))
    assert sorted(single) == sorted(multi)
    for name in single:
        assert single[name].dtype == multi[name].dtype
        np.testing.assert_array_equal(multi[name], single[name])
    final = str(ckpt / "multi-fused-f32-final")
    whole, _ = load_checkpoint(final)
    sharded = [n for n in whole if n == "emb" or n.startswith("adam/emb/")]
    assert len(sharded) == 3 and whole["emb"].shape == (512, 16)
    one = tmesh.Mesh((torch.device("cpu"),) * S)
    for p in range(PROCS):
        two = tmesh.Mesh((torch.device("cpu"),) * (S // PROCS),
                         process_index=p, process_count=PROCS)
        for mesh in (one, two):
            got, _ = load_checkpoint(final, mesh=mesh, node_sharded=sharded)
            for name, value in whole.items():
                want = value[p * 256:(p + 1) * 256] if (
                    mesh is two and name in sharded) else value
                np.testing.assert_array_equal(got[name], want)
    single_final, _ = load_checkpoint(str(ckpt / "single-fused-f32-final"))
    for name, value in single_final.items():
        np.testing.assert_allclose(whole[name], value, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(value).max()))


def test_put_global_keeps_this_process_rows():
    a = np.arange(24, dtype=np.float32).reshape(8, 3)
    one = tmesh.Mesh((torch.device("cpu"),) * 4)
    np.testing.assert_array_equal(tmesh.put_global(a, one).numpy(), a)
    for p in range(2):
        mesh = tmesh.Mesh((torch.device("cpu"),) * 2, process_index=p,
                          process_count=2)
        got = tmesh.put_global(a, mesh)
        np.testing.assert_array_equal(got.numpy(), a[p * 4:(p + 1) * 4])
        got += 1                                  # a copy, not a view
    np.testing.assert_array_equal(a, np.arange(24).reshape(8, 3))
    with pytest.raises(ValueError, match="do not split"):
        tmesh.put_global(np.zeros((6, 3)), tmesh.Mesh(
            (torch.device("cpu"),) * 2, process_index=0, process_count=2))
    np.testing.assert_array_equal(tmesh.gather_global(a, one), a)


_GRAD_SUM = """
import sys, numpy as np, torch
from scaling_rgcn_training_tpu_torch.parallel import mesh as m
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
m.initialize_multihost(init, 2, rank, "gloo")
mesh = m.make_mesh(devices=("cpu",))
params = [torch.nn.Parameter(torch.zeros(5, 3)), torch.nn.Parameter(
    torch.zeros(7)), torch.nn.Parameter(torch.zeros(2))]
rng = np.random.default_rng(10 + rank)
for p in params[:2]:
    p.grad = torch.tensor(rng.standard_normal(p.shape).astype(np.float32))
runs = []
for _ in range(2):
    saved = [None if p.grad is None else p.grad.clone() for p in params]
    m.sum_replicated_grads(params, mesh)
    runs.append([p.grad.numpy().copy() for p in params])
    for p, g in zip(params, saved):
        p.grad = g
total = m.sum_across(0.25 * (rank + 1), mesh)
rows = m.gather_global(np.full((2, 3), rank, np.float32), mesh)
np.savez(out, *runs[0], *runs[1], total=total, rows=rows)
"""


def test_gradient_sum_across_two_processes(tmp_path):
    """``sum_replicated_grads`` in 2 gloo processes: every process gets
    rank 0's gradients plus rank 1's, in that order, bit for bit (a
    parameter without a gradient counts zeros), twice the same; and
    ``sum_across`` and ``gather_global`` alongside."""
    init = f"file://{tmp_path / 'rendezvous'}"
    env = _env()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GRAD_SUM, str(r), init,
         str(tmp_path / f"out{r}.npz")], cwd=ROOT, env=env,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), errs
    shapes = [(5, 3), (7,), (2,)]
    grads = []
    for r in range(2):
        rng = np.random.default_rng(10 + r)
        grads.append([rng.standard_normal(s).astype(np.float32)
                      for s in shapes[:2]] + [np.zeros(2, np.float32)])
    want = [g0 + g1 for g0, g1 in zip(*grads)]
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        for i, w in enumerate(want * 2):
            np.testing.assert_array_equal(out[f"arr_{i}"], w)
        assert float(out["total"]) == 0.75
        np.testing.assert_array_equal(out["rows"],
                                      np.repeat([0.0, 1.0], 2)[:, None]
                                      * np.ones((1, 3)))
