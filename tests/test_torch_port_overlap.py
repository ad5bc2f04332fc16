"""The halo exchange's overlap with the owner-local aggregation, on the CPU.

``parallel/halo.py`` runs the exchange on each card's exchange stream while
the owner-local segment runs on the compute stream; ``RGCN_HALO_BLOCK_OVERLAP``
is the blocked arm (the JAX package's ``optimization_barrier``). On the
CPU no stream exists and both arms run the same ops in the same order, so
they must give the same bits; each arm is held against the JAX
``halo_aggregate`` run with the same variable, on 4 of the 8 virtual CPU
devices of ``tests/conftest.py`` (the gather backend, as the JAX package
runs on the CPU). Tolerances: float32 within 1e-5 * max|ref| (other
summation order), bfloat16 streams within 2e-2 * max|ref| (the packages
round to bf16 at other places). The weight's cotangents of the shards'
segments are added in the order autograd added them when each shard's
``local + halo`` ran in turn, bit for bit. ``measure_overlap`` runs at a
small size, and the trace's window count is checked on a written trace.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_rgcn_training_tpu.parallel import halo as jhalo
from scaling_rgcn_training_tpu.parallel.mesh import make_mesh as j_make_mesh
from scaling_rgcn_training_tpu_torch import measure_overlap as mo
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import relational_aggregate
from scaling_rgcn_training_tpu_torch.parallel import halo as thalo
from scaling_rgcn_training_tpu_torch.parallel import ring_halo as tring
from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh, shard_rows
from scaling_rgcn_training_tpu_torch.utils import tracing

S = 4
N, E, R, D_IN, D_OUT = 61, 420, 4, 8, 6


def _graph(seed=3, n=N, e=E, r=R):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 3, e).astype(np.int32)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)
    return src, dst, typ, n, 2 * r + 1


GRAPH = _graph()
_rng = np.random.default_rng(5)
X = _rng.standard_normal((N, D_IN)).astype(np.float32)
W = (_rng.standard_normal((GRAPH[4], D_IN, D_OUT)) * 0.3).astype(np.float32)
GOUT = _rng.standard_normal((N, D_OUT)).astype(np.float32)
ARMS = {"overlapped": None, "blocked": "1"}


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(devices=("cpu",) * S)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX ``halo_aggregate``'s value and ``x``, ``w`` gradients with
    ``RGCN_HALO_BLOCK_OVERLAP`` unset and set, float32 and bfloat16."""
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} virtual JAX devices")
    jmesh = j_make_mesh(S)
    src, dst, typ, n, slots = GRAPH
    he = jhalo.device_put_halo_edges(jhalo.halo_partition_edges(
        src, dst, typ, n, slots, S, pad_to_multiple=8, halo_multiple=4), jmesh)
    xp = jax.device_put(jhalo.pad_node_array(jnp.asarray(X), he),
                        jhalo.node_sharding(jmesh))
    gout = jhalo.pad_node_array(jnp.asarray(GOUT), he)
    refs = {}
    mp = pytest.MonkeyPatch()
    try:
        for arm, value in ARMS.items():
            if value is None:
                mp.delenv(thalo.BLOCK_OVERLAP_ENV, raising=False)
            else:
                mp.setenv(thalo.BLOCK_OVERLAP_ENV, value)
            for dtype in ("float32", "bfloat16"):
                cast = (lambda a: a) if dtype == "float32" else \
                    (lambda a: a.astype(jnp.bfloat16))

                def f(xv, wv):
                    out = jhalo.halo_aggregate(cast(xv), cast(wv), he, jmesh,
                                               backend="gather")
                    return jnp.sum(out * gout), out

                # a new function each time: the variable is read when
                # jit traces it
                (_, out), (gx, gw) = jax.jit(jax.value_and_grad(
                    f, argnums=(0, 1), has_aux=True))(xp, jnp.asarray(W))
                refs[(arm, dtype)] = [np.asarray(a, np.float32)
                                      for a in (out, gx, gw)]
    finally:
        mp.undo()
    return refs


def _port(he, mesh, dtype, backend):
    """The port's ``halo_aggregate``: value, dx, dw (float32 numpy)."""
    x = torch.zeros(thalo.padded_num_nodes(he), D_IN)
    x[:N] = torch.tensor(X)
    x.requires_grad_(True)
    w = torch.tensor(W, requires_grad=True)
    gout = torch.zeros(thalo.padded_num_nodes(he), D_OUT)
    gout[:N] = torch.tensor(GOUT)
    cast = (lambda t: t) if dtype == "float32" else \
        (lambda t: t.to(torch.bfloat16))
    out = thalo.halo_aggregate(shard_rows(cast(x), mesh), cast(w), he, mesh,
                               backend=backend).gather()
    (out * gout).sum().backward()
    return [t.detach().float() for t in (out, x.grad, w.grad)]


def _no_streams(monkeypatch):
    """Make any stream code raise: none may run on the CPU."""
    def refuse(*a, **k):
        raise AssertionError("stream code ran on the CPU")
    monkeypatch.setattr(tring, "exchange_stream", refuse)
    monkeypatch.setattr(tring.Overlap, "on", refuse)


@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exchange", [None, "1"])
def test_arms_same_bits_and_match_jax(jax_refs, tmesh, exchange, dtype,
                                      backend, monkeypatch):
    """The library exchange and #6's plain version, span (#1, #2's plain
    versions) and edge mode: both arms give the same bits of the value and
    the ``x`` and ``w`` gradients, run no stream code, and each is within
    the tolerance of the JAX ``halo_aggregate`` under the same variable."""
    _no_streams(monkeypatch)
    if exchange is None:
        monkeypatch.delenv(thalo.EXCHANGE_ENV, raising=False)
    else:
        monkeypatch.setenv(thalo.EXCHANGE_ENV, exchange)
    src, dst, typ, n, slots = GRAPH
    he = thalo.device_put_halo_edges(thalo.halo_partition_edges(
        src, dst, typ, n, slots, S, pad_to_multiple=8, halo_multiple=4), tmesh)
    got = {}
    for arm, value in ARMS.items():
        if value is None:
            monkeypatch.delenv(thalo.BLOCK_OVERLAP_ENV, raising=False)
        else:
            monkeypatch.setenv(thalo.BLOCK_OVERLAP_ENV, value)
        assert thalo.overlap_blocked() == (value is not None)
        got[arm] = _port(he, tmesh, dtype, backend)
    assert tracing.same_bits(got["overlapped"], got["blocked"])
    frac = 1e-5 if dtype == "float32" else 2e-2
    for arm in ARMS:
        ref = jax_refs[(arm, dtype)]
        for name, g, r in zip(("out", "dx", "dw"), got[arm], ref):
            g = g.numpy()
            if name != "dw":
                g, r = g[:N], r[:N]
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=frac * float(np.abs(r).max()),
                                       err_msg=f"{arm} {name}")


@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [2, 5])
def test_weight_cotangents_in_the_engines_order(shards, dtype, backend):
    """``halo_aggregate`` against each shard's ``local + halo`` run in
    turn on the one ``w`` (autograd then adds the segments' ``w``
    cotangents as they arrive, shard S - 1 first): the value and the ``x``
    and ``w`` gradients with the same bits, so the overlapped issue order
    (every local segment before the halo segments) keeps them."""
    mesh = make_mesh(devices=("cpu",) * shards)
    src, dst, typ, n, slots = _graph(seed=shards, n=97, e=900)
    he = thalo.device_put_halo_edges(thalo.halo_partition_edges(
        src, dst, typ, n, slots, shards, pad_to_multiple=8, halo_multiple=4),
        mesh)
    gen = torch.Generator().manual_seed(shards)
    cast = (lambda t: t) if dtype == "float32" else \
        (lambda t: t.to(torch.bfloat16))
    x0 = torch.randn(thalo.padded_num_nodes(he), 16, generator=gen)
    w0 = torch.randn(slots, 16, 8, generator=gen)
    gout = torch.randn(x0.shape[0], 8, generator=gen)
    mode = "fused" if backend is None else "edge"

    def in_turn(x, w):
        xs = list(x.split(he.n_per))
        sends = [thalo.SendGather.apply(xs[s], sh).view(shards, he.halo, 16)
                 for s, sh in enumerate(he.shards)]
        recvs = tring.HaloExchange.apply("library", None, None, *sends)
        return torch.cat([
            relational_aggregate(xs[s], w, sh.local, mode, backend)
            + relational_aggregate(recvs[s].reshape(-1, 16), w, sh.halo,
                                   mode, backend)
            for s, sh in enumerate(he.shards)])

    res = []
    for fn in (in_turn, lambda x, w: thalo.halo_aggregate(
            shard_rows(x, mesh), w, he, mesh, backend=backend).gather()):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        out = fn(cast(x), cast(w))
        (out * gout).sum().backward()
        res.append((out.detach(), x.grad, w.grad))
    assert tracing.same_bits(*res)


def test_measure_overlap_on_the_cpu(monkeypatch, capsys):
    """``measure_overlap`` at a small size on 4 virtual CPU shards: the JAX
    script's lines for both arms, then its JSON record with both arms'
    times, no window (no card) and the arms' bits equal."""
    for name, value in (("OV_NODES", "2000"), ("OV_EDGES", "20000"),
                        ("OV_DEVICES", "4"), ("OV_INNER", "2")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv(thalo.EXCHANGE_ENV, raising=False)
    _no_streams(monkeypatch)
    rec = mo.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device=cpu (cpu) shards=4")
    assert any(ln.startswith("overlapped") and "ms/agg" in ln for ln in lines)
    assert any(ln.startswith("blocked") and "ms/agg" in ln for ln in lines)
    assert any(ln.startswith("overlap gain: ") and
               "% slower when blocked)" in ln for ln in lines)
    assert json.loads(lines[-1]) == json.loads(json.dumps(rec))
    assert set(rec) >= {"device", "kind", "shards", "nodes", "edges", "slots",
                        "halo_rows", "exchange", "arms", "gain_ms",
                        "gain_ms_fwd_bwd", "same_bits"}
    assert rec["same_bits"] and rec["exchange"] == "library"
    assert rec["device"] == "cpu" and rec["shards"] == 4 and rec["slots"] == 25
    for arm in ("overlapped", "blocked"):
        a = rec["arms"][arm]
        assert a["window"] is None
        assert a["ms_per_agg"] > 0 and a["ms_per_agg_fwd_bwd"] > 0
    monkeypatch.setenv(thalo.EXCHANGE_ENV, "fused")
    with pytest.raises(SystemExit):
        mo.main(["--device", "cpu"])


def test_stream_overlap_counts_the_window(tmp_path):
    """``tracing.stream_overlap`` over a written Chrome trace: the stream
    with the most events is the compute stream, the others' events the
    window; the compute kernels that meet it are counted (one touching its
    end is not), on each card apart, with the window's and the overlap's
    ms, the cards' busy and spanned ms, and the windows that ended before
    the host launched the next compute kernel (linked by correlation)."""
    def ev(name, dev, stream, ts, dur, cat="kernel", corr=None):
        args = {"device": dev, "stream": stream}
        if corr is not None:
            args["correlation"] = corr
        return {"ph": "X", "cat": cat, "name": name, "pid": dev,
                "tid": stream, "ts": ts, "dur": dur, "args": args}

    def launch(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 1, "tid": 1, "ts": ts, "dur": 2,
                "args": {"correlation": corr}}

    events = [
        ev("void gather<float>(float*)", 0, 7, 0, 10),
        ev("Memcpy DtoD", 0, 21, 10, 40, "gpu_memcpy"),
        ev("void (anonymous namespace)::span_msg_kernel<float>(int)", 0, 7,
           12, 10, corr=1),
        ev("span_msg_sum_kernel", 0, 7, 25, 10),
        ev("halo_pull_kernel", 0, 21, 45, 15),
        ev("late", 0, 7, 60, 5),
        ev("a", 1, 3, 0, 5), ev("b", 1, 3, 5, 5), ev("c", 1, 9, 20, 5),
        ev("x", 2, 1, 0, 5), ev("exchange", 2, 2, 10, 10),
        ev("y", 2, 1, 30, 5, corr=2),
        launch(1, 5), launch(2, 28),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 99},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = tracing.gpu_events(str(path))
    assert len(got) == 12 and got == sorted(got, key=lambda e: e["start"])
    assert [e["launch"] for e in got if e["name"] in ("y",)] == [28.0]
    res = tracing.stream_overlap(got)
    assert res["inside"] == 2
    assert res["kernels"] == {"span_msg_kernel": 1, "span_msg_sum_kernel": 1}
    assert res["window_ms"] == pytest.approx((50 + 5 + 10) / 1e3)
    assert res["overlap_ms"] == pytest.approx(20 / 1e3)
    assert (res["windows"], res["host_late"]) == (2, 1)
    assert res["busy_ms"] == pytest.approx((65 + 15 + 20) / 1e3)
    assert res["span_ms"] == pytest.approx((65 + 25 + 35) / 1e3)
    assert res["streams"] == {"0": {"compute": 7, "window": [21]},
                              "1": {"compute": 3, "window": [9]},
                              "2": {"compute": 1, "window": [2]}}
