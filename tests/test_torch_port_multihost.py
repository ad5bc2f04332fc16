"""Training across processes, in the halo partition and the edge
partition: the port's 2 processes x 2 shards against its single-process
4-shard run and against the JAX package's loops, on the CPU.

``python -m scaling_rgcn_training_tpu_torch.multihost_sim`` runs the
single-process oracle, then spawns 2 processes that join a gloo group
through a ``file://`` rendezvous under the test's ``tmp_path`` (so xdist
workers never share a port), each with 2 virtual CPU shards, for the
library exchange, kernel #6, kernel #7 (their plain versions across
processes on the CPU) and the edge partition (#3, #4 and #5's plain
versions on every process's shards, the cross-process sums of
``parallel/spmd.py``), at the JAX test's size (N 512, E 4096, 3 steps,
float32). Tolerances: between the port's two layouts the JAX script's
(``rtol=1e-5, atol=1e-6``: the loss and the replicated gradients are
summed in another order; the edge partition's losses keep their bits,
since it adds the same per-shard partials and cotangents in the same
order in both layouts); against JAX
the convs' tests' float32 tolerance, ``1e-5 * max|ref|`` (other summation
order). The JAX side runs on 4 of the 8 virtual CPU devices of
``tests/conftest.py``.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scaling_rgcn_training_tpu.ops.rgcn_conv import RGCNLayerParams
from scaling_rgcn_training_tpu.parallel import halo as jhalo
from scaling_rgcn_training_tpu.parallel import spmd as jspmd
from scaling_rgcn_training_tpu.parallel.mesh import make_mesh as j_make_mesh
from scaling_rgcn_training_tpu.train.losses import bce_loss
from scaling_rgcn_training_tpu_torch import multihost_sim as mh
from scaling_rgcn_training_tpu_torch.graphs.device import build_device_graph
from scaling_rgcn_training_tpu_torch.parallel import mesh as tmesh
from scaling_rgcn_training_tpu_torch.parallel import spmd as tspmd
from scaling_rgcn_training_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = {"MH_NODES": "512", "MH_EDGES": "4096", "MH_STEPS": "3",
         "MH_BF16": "0", "MH_REORDER": "1", "MH_LABELLED": "128"}
HALO_MODES = ("library", "kernel", "fused")
MODES = (*HALO_MODES, "edge")
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
    mode, with the cross-process checks and the checkpoints."""
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


def _jax_loop(conv, params, rows, y, steps=3):
    """``steps`` steps of embedding -> ``conv`` -> ReLU -> ``conv`` -> BCE
    -> ``optax.adam(0.05)`` in JAX: the loss series."""
    opt = optax.adam(mh.LR)
    state = opt.init(params)

    def loss_of(p):
        e, a, b = p
        logits = conv(jax.nn.relu(conv(e, a)), b)
        return bce_loss(logits[jnp.asarray(rows)], jnp.asarray(y))

    @jax.jit
    def step(p, st):
        loss, grads = jax.value_and_grad(loss_of)(p)
        updates, st = opt.update(grads, st)
        return optax.apply_updates(p, updates), st, loss

    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return losses


def _jax_graph():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} virtual JAX devices")
    knobs = {"nodes": 512, "edges": 4096, "rels": 5, "reorder": True}
    src, dst, typ, slots = mh.make_graph(knobs, S)
    rows, y = mh.labels(knobs["nodes"], 4, 128)
    return src, dst, typ, slots, knobs["nodes"], rows, y, j_make_mesh(S)


def _jax_params(emb, layers):
    return (jnp.asarray(emb),
            *[RGCNLayerParams(*map(jnp.asarray, layer)) for layer in layers])


@pytest.fixture(scope="module")
def jax_losses():
    """The JAX package's halo loop (``halo_partition_edges``,
    ``halo_rgcn_conv`` with ``backend="gather"``, ``bce_loss``,
    ``optax.adam(0.05)``) over 4 virtual devices, on the port's graph and
    numpy-made parameters."""
    src, dst, typ, slots, n, rows, y, jmesh = _jax_graph()
    he = jhalo.device_put_halo_edges(jhalo.halo_partition_edges(
        src, dst, typ, n, slots, S, pad_to_multiple=64, halo_multiple=8),
        jmesh)
    emb, layers = mh.make_params(jhalo.padded_num_nodes(he), [16, 8, 4],
                                 slots)
    emb, *rest = _jax_params(emb, layers)
    params = (jax.device_put(emb, jhalo.node_sharding(jmesh)), *rest)
    return _jax_loop(lambda x, p: jhalo.halo_rgcn_conv(
        x, he, p, jmesh, backend="gather"), params, rows, y)


@pytest.fixture(scope="module")
def jax_edge_losses():
    """The JAX package's edge partition loop (``shard_rel_edges``,
    ``sharded_rgcn_conv`` with ``backend="gather"``, ``bce_loss``,
    ``optax.adam(0.05)``) over 4 virtual devices, the embedding
    replicated, on the port's graph and numpy-made parameters."""
    src, dst, typ, slots, n, rows, y, jmesh = _jax_graph()
    se = jspmd.device_put_sharded_edges(
        jspmd.shard_rel_edges(src, dst, typ, n, slots, S), jmesh)
    params = _jax_params(*mh.make_params(n, [16, 8, 4], slots))
    return _jax_loop(lambda x, p: jspmd.sharded_rgcn_conv(
        x, se, p, jmesh, backend="gather"), params, rows, y)


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
    # both processes ended with the same loss series and the same bits of
    # every replicated tensor and Adam moment
    assert m["replicated_bits_equal"] is True
    if mode == "edge":
        # the forward adds the same 4 partials in the same order, and the
        # backward the same 4 shards' cotangents: every loss keeps its bits
        assert m["first_loss_same_bits"] is True
        assert m["loss_series_same_bits"] is True
        assert m["multi_process_losses"] == m["single_process_losses"]
    # each process launched nothing (plain versions on the CPU)
    assert all(not any(step.values()) for proc in m["launches"]
               for step in proc)


@pytest.mark.parametrize("mode", HALO_MODES)
def test_port_matches_jax_halo_loop(run, jax_losses, mode):
    """Both of the port's layouts against the JAX halo loop: float32,
    ``1e-5 * max|ref|``."""
    rec, _ = run
    m = rec["modes"][f"{mode}-f32"]
    atol = 1e-5 * max(abs(v) for v in jax_losses)
    for series in ("single_process_losses", "multi_process_losses"):
        np.testing.assert_allclose(m[series], jax_losses, rtol=0, atol=atol,
                                   err_msg=series)


def test_port_matches_jax_edge_partition_loop(run, jax_edge_losses):
    """Both of the port's edge-partition layouts (2 processes x 2 shards,
    and 4 shards in one process) against the JAX ``sharded_rgcn_conv``
    loop: float32, ``1e-5 * max|ref|``."""
    rec, _ = run
    m = rec["modes"]["edge-f32"]
    atol = 1e-5 * max(abs(v) for v in jax_edge_losses)
    for series in ("single_process_losses", "multi_process_losses"):
        np.testing.assert_allclose(m[series], jax_edge_losses, rtol=0,
                                   atol=atol, err_msg=series)


def _edge_final(ckpt):
    ranks = [load_checkpoint(str(ckpt / f"multi-edge-f32-final-rank{r}"))[0]
             for r in range(PROCS)]
    single, _ = load_checkpoint(str(ckpt / "single-edge-f32-final"))
    return ranks, single


def test_edge_partition_replicated_state_bit_equal_across_processes(run):
    """After the last step every replicated tensor (the embedding, each
    layer's weight, root and bias) and each of their Adam moments has the
    same bits on both processes, read from each process's own
    checkpoint: a missing cross-process sum would split them."""
    _, ckpt = run
    ranks, _ = _edge_final(ckpt)
    names = sorted(ranks[0])
    assert names == sorted(ranks[1])
    assert {"emb", "adam/emb/exp_avg", "adam/emb/exp_avg_sq"} <= set(names)
    for i in range(2):
        for p in ("weight", "root", "bias"):
            assert {f"layer{i}/{p}", f"adam/layer{i}/{p}/exp_avg",
                    f"adam/layer{i}/{p}/exp_avg_sq"} <= set(names)
    assert ranks[0]["emb"].shape == (512, 16)    # every row, not sharded
    for name in names:
        assert ranks[0][name].dtype == ranks[1][name].dtype
        np.testing.assert_array_equal(ranks[1][name], ranks[0][name],
                                      err_msg=name)


def test_edge_partition_counts_replicated_gradients_once(run):
    """The replicated gradients (root, bias, the embedding's root term)
    are whole on every process and are not summed across processes again:
    after the last step the processes' parameters and Adam moments have
    the single-process run's bits (its shards' sums in the same order). A
    second sum would scale the first moments by P and the second by P^2,
    which Adam's normalised step hides from the losses."""
    _, ckpt = run
    ranks, single = _edge_final(ckpt)
    assert sorted(single) == sorted(ranks[0])
    for name, want in single.items():
        np.testing.assert_array_equal(ranks[0][name], want, err_msg=name)


def test_edge_sums_across_processes_match_one_process(run):
    """Each process held one layer of the edge partition across processes
    against the one-process ``sharded_aggregate`` of all shards, at S = 2
    and 4, float32 and bfloat16: the summed output and the ``x`` and
    ``w`` cotangents bit for bit (``multihost_sim`` raises otherwise)."""
    rec, _ = run
    assert len(rec["edge_check"]) == PROCS
    for proc in rec["edge_check"]:
        assert [(c["shards"], c["edges"]) for c in proc] == [
            (2, 5000), (2, 600), (4, 10000), (4, 600)]


def test_edge_partition_gathers_each_shards_tensors_once_a_step(run):
    """The bytes each process contributes to the cross-process sums a
    step: its 2 shards' partial sums ``[N, h]`` of both layers (float32)
    and, backward, its 2 shards' ``x`` and ``w`` cotangents of both
    layers; every process receives as much from the other."""
    rec, _ = run
    m = rec["modes"]["edge-f32"]
    n, (d, hl, c), slots, k = 512, rec["widths"], rec["slots"], S // PROCS
    partials = k * n * (hl + c)
    cotangents = k * (n * (d + hl) + slots * (d * hl + hl * c))
    assert m["gathered_mb_per_step"] == [(partials + cotangents) * 4 / 1e6] \
        * PROCS
    assert all(not any(m["gathered_mb_per_step"])
               for tag, m in rec["modes"].items() if tag != "edge-f32")


def test_edge_partition_padding_only_shards_do_not_hang(run):
    """600 edges in shards of 512 over 4 shards leave shards 2 and 3 with
    only padding rows, so process 1 aggregates nothing: it still entered
    every gather, forward and backward (the run ended within its
    ``--timeout``), and its output and gradients had one process's bits
    (the check raises otherwise)."""
    rec, _ = run
    by_proc = [[c for c in proc if (c["shards"], c["edges"]) == (4, 600)]
               for proc in rec["edge_check"]]
    assert [[c["local_edges"] for c in cs] for cs in by_proc] == [
        [[512, 88]], [[0, 0]]]


def test_device_put_sharded_edges_keeps_this_process_shards():
    """On a mesh of several processes the edge partition's placement (and
    ``build_device_graph(partition="edge")``) keeps the plans of this
    process's global shards only; in one process every shard's."""
    rng = np.random.default_rng(3)
    n, e, slots = 90, 3000, 5
    src, dst, typ = (rng.integers(0, n, e).astype(np.int32),
                     rng.integers(0, n, e).astype(np.int32),
                     rng.integers(0, slots, e).astype(np.int32))
    host = tspmd.shard_rel_edges(src, dst, typ, n, slots, S)
    graph = SimpleNamespace(edge_src=src, edge_dst=dst, edge_type=typ,
                            num_nodes=n, num_relation_slots=slots,
                            x_train=np.arange(4), y_train=np.eye(4),
                            x_val=None, y_val=None, x_test=None, y_test=None)
    one = tmesh.Mesh((torch.device("cpu"),) * S)
    placed = tspmd.device_put_sharded_edges(host, one)
    assert [sh.num_edges for sh in placed.shards] == \
        [sh.num_edges for sh in host.shards]
    for p in range(PROCS):
        mesh = tmesh.Mesh((torch.device("cpu"),) * (S // PROCS),
                          process_index=p, process_count=PROCS)
        for edges in (tspmd.device_put_sharded_edges(host, mesh),
                      build_device_graph(graph, "cpu", mesh=mesh,
                                         partition="edge").edges):
            assert edges.num_shards == S and len(edges.shards) == S // PROCS
            for got, want in zip(edges.shards, host.shards[p * 2:p * 2 + 2]):
                assert torch.equal(got.src, want.src)
                assert torch.equal(got.dst, want.dst)
                assert got.group_offsets == want.group_offsets
    with pytest.raises(ValueError, match="shards"):
        tspmd.device_put_sharded_edges(host, tmesh.Mesh(
            (torch.device("cpu"),) * 3, process_index=0, process_count=2))


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
        got = tmesh.put_global(a, mesh)           # one tensor a shard
        assert [tuple(t.shape) for t in got] == [(2, 3), (2, 3)]
        np.testing.assert_array_equal(got.numpy(), a[p * 4:(p + 1) * 4])
        for t in got:
            t += 1                                # a copy, not a view
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
# leave the group before exiting: a gloo group torn down by the exit
# itself can abort the process while its peer closes the connection
torch.distributed.destroy_process_group()
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


def test_relative_workdir(tmp_path):
    """A ``--workdir`` relative to the current directory: the children's
    rendezvous file lies inside it (a relative path once made the
    ``file://`` URL name a host, and both children failed to start)."""
    res = subprocess.run(
        [sys.executable, "-m", "scaling_rgcn_training_tpu_torch.multihost_sim",
         "--device", "cpu", "--procs", "2", "--shards-per-proc", "1",
         "--modes", "library", "--workdir", "rel/work", "--timeout", "120"],
        cwd=tmp_path, env=dict(_env(), MH_STEPS="1"), capture_output=True,
        text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["loss_parity"] is True
    assert list((tmp_path / "rel" / "work").glob("child0.err"))
