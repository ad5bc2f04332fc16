"""The port's halo partition against the JAX package's, on the CPU.

The JAX side runs on 4 of the 8 virtual CPU devices (tests/conftest.py);
the port on a mesh of 4 virtual CPU shards, where kernels #6 and #7 run
their plain versions. Same graph and inputs from one numpy seed, weights
carried across as numpy. Tolerances: float32 within 1e-5 * max|ref|
(other summation order), bfloat16 edge streams within 2e-2 * max|ref|
(the packages round to bf16 at other places).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from scaling_rgcn_training_tpu.ops import init_rgcn_layer as j_init_layer
from scaling_rgcn_training_tpu.parallel import halo as jhalo
from scaling_rgcn_training_tpu.parallel.mesh import EDGE_AXIS, make_mesh as j_make_mesh
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer
from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
from scaling_rgcn_training_tpu_torch.parallel import fused_halo as tfused
from scaling_rgcn_training_tpu_torch.parallel import halo as thalo
from scaling_rgcn_training_tpu_torch.parallel import ring_halo as tring
from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh, shard_rows

S = 4


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} virtual JAX devices")
    return j_make_mesh(S)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(devices=("cpu",) * S)


def _graph(kind="uniform", seed=0, n=53, e=337, r=4):
    rng = np.random.default_rng(seed)
    if kind == "hub":
        # Zipf endpoints: a few hubs carry most edges and every shard reads
        # them, the worst case of the per-(reader, owner) halo sizing
        zipf = lambda: np.minimum(rng.zipf(1.6, e) - 1, n - 1).astype(np.int32)
        src, dst = zipf(), zipf()
    else:
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n - 3, e).astype(np.int32)   # 3 rows get none
    typ = rng.integers(0, 2 * r, e).astype(np.int32)
    return src, dst, typ, n, 2 * r + 1


FIELDS = ("lsrc", "ldst", "lnorm", "lgs", "hsrc", "hdst", "hnorm", "hgs",
          "send_idx")


@pytest.mark.parametrize("kind", ["uniform", "hub"])
def test_partition_plan_matches_jax(kind):
    """Every host field, ``n_per`` and ``halo`` equal the JAX build's; the
    port's device plans hold every real edge once."""
    src, dst, typ, n, slots = _graph(kind)
    ref = jhalo._halo_partition_edges_host(src, dst, typ, n, slots, S, 8, 4)
    got = thalo.halo_partition_edges(src, dst, typ, n, slots, S,
                                     pad_to_multiple=8, halo_multiple=4)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert (got.n_per, got.halo, got.num_shards) == (ref.n_per, ref.halo, S)
    placed = thalo.device_put_halo_edges(got, make_mesh(devices=("cpu",) * S))
    assert sum(sh.local.num_edges + sh.halo.num_edges
               for sh in placed.shards) == len(src)
    assert sum(int(sh.fused.src.numel()) for sh in placed.shards) == len(src)
    assert placed.shards[0].halo.span.num_src == S * got.halo


def test_plain_exchange_matches_all_to_all(jmesh):
    """Kernel #6's plain version (and the library exchange) against
    ``lax.all_to_all`` inside ``shard_map``."""
    rng = np.random.default_rng(1)
    send = rng.standard_normal((S, S, 5, 3)).astype(np.float32)
    want = jax.jit(jax.shard_map(
        lambda v: jax.lax.all_to_all(v[0], EDGE_AXIS, 0, 0, tiled=False)[None],
        mesh=jmesh, in_specs=P(EDGE_AXIS), out_specs=P(EDGE_AXIS),
        check_vma=False))(jnp.asarray(send))
    sends = [torch.tensor(send[p]) for p in range(S)]
    for fn in (tring.halo_exchange, tring.halo_exchange_plain,
               tring.halo_exchange_library):
        got = torch.stack(fn(sends)).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
    # its own transpose: exchanging twice restores the sends
    back = tring.halo_exchange(tring.halo_exchange(sends))
    np.testing.assert_array_equal(torch.stack(back).numpy(), send)


def _layer(params):
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    return RGCNLayer(t(params.weight), t(params.root), t(params.bias))


CONV_GRAPH = _graph(seed=3)
CONV_X = np.random.default_rng(5).standard_normal((53, 8)).astype(np.float32)
GOUT = np.random.default_rng(7).standard_normal((53, 6)).astype(np.float32)


@pytest.fixture(scope="module")
def conv_refs(jmesh):
    """The JAX halo conv's values and gradients (``backend="gather"``,
    default exchange) in float32 and with bfloat16 streams, once."""
    params = j_init_layer(jax.random.key(2), CONV_GRAPH[4], 8, 6)
    return params, {cd: _jax_conv(jmesh, CONV_GRAPH, CONV_X, params, cd)
                    for cd in (None, jnp.bfloat16)}


def _jax_conv(jmesh, graph, x, params, compute_dtype):
    src, dst, typ, n, slots = graph
    he = jhalo.device_put_halo_edges(jhalo.halo_partition_edges(
        src, dst, typ, n, slots, S, pad_to_multiple=8, halo_multiple=4), jmesh)
    xp = jax.device_put(jhalo.pad_node_array(jnp.asarray(x), he),
                        jhalo.node_sharding(jmesh))

    def f(p, xv):
        out = jhalo.halo_rgcn_conv(xv, he, p, jmesh, backend="gather",
                                   compute_dtype=compute_dtype)
        return jnp.sum(out[:n] * jnp.asarray(GOUT)), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, xp)
    return [np.asarray(a) for a in (out, gx, gp.weight, gp.root, gp.bias)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,backend", [(None, None), ("1", None),
                                          ("fused", None), (None, "gather")])
def test_halo_conv_matches_jax(conv_refs, tmesh, mode, backend, dtype,
                               monkeypatch):
    """Values and gradients of the port's halo conv in each exchange mode
    (library; kernel #6; kernel #7; and the edge mode behind a backend)
    against the JAX halo conv with its default exchange."""
    src, dst, typ, n, slots = CONV_GRAPH
    x = CONV_X
    cd = None if dtype == "float32" else dtype
    params, refs = conv_refs
    ref = refs[cd and jnp.bfloat16]

    if mode is None:
        monkeypatch.delenv(thalo.EXCHANGE_ENV, raising=False)
    else:
        monkeypatch.setenv(thalo.EXCHANGE_ENV, mode)
    he = thalo.device_put_halo_edges(thalo.halo_partition_edges(
        src, dst, typ, n, slots, S, pad_to_multiple=8, halo_multiple=4), tmesh)
    layer = _layer(params)
    xp = torch.zeros(thalo.padded_num_nodes(he), 8)
    xp[:n] = torch.tensor(x)
    xp.requires_grad_(True)
    before = dict(LAUNCHES)
    out = thalo.halo_rgcn_conv(shard_rows(xp, tmesh), he, layer, tmesh,
                               backend=backend,
                               compute_dtype=cd and torch.bfloat16).gather()
    (out[:n] * torch.tensor(GOUT)).sum().backward()
    assert LAUNCHES == before          # the CPU runs the plain versions
    got = [out, xp.grad, layer.weight.grad, layer.root.grad, layer.bias.grad]
    frac = 1e-5 if dtype == "float32" else 2e-2
    for name, g, r in zip(("out", "dx", "dW", "droot", "dbias"), got, ref):
        g = g.detach().numpy()
        if name in ("out", "dx"):
            g, r = g[:n], r[:n]
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=frac * float(np.abs(r).max()),
                                   err_msg=name)


def test_fused_mode_on_an_uncovered_layer_warns_and_takes_the_library(
        tmesh, monkeypatch):
    """``RGCN_HALO_PALLAS_A2A=fused`` with a ``backend``: a warning, then
    the library exchange, whose result equals the default run's."""
    src, dst, typ, n, slots = _graph(seed=4)
    he = thalo.device_put_halo_edges(thalo.halo_partition_edges(
        src, dst, typ, n, slots, S, pad_to_multiple=8, halo_multiple=4), tmesh)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(thalo.padded_num_nodes(he), 8, generator=gen)
    w = torch.randn(slots, 8, 6, generator=gen)
    monkeypatch.delenv(thalo.EXCHANGE_ENV, raising=False)
    x = shard_rows(x, tmesh)
    want = thalo.halo_aggregate(x, w, he, tmesh, backend="gather").gather()
    monkeypatch.setenv(thalo.EXCHANGE_ENV, "fused")
    with pytest.warns(UserWarning, match="library exchange"):
        got = thalo.halo_aggregate(x, w, he, tmesh, backend="gather").gather()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_plain_buffer_is_the_exchanged_halo(tmesh):
    """Kernel #7's plain version writes the halo buffer the library
    exchange delivers, and aggregates like the span plans of the local
    and halo segments together."""
    src, dst, typ, n, slots = _graph("hub", seed=2)
    he = thalo.device_put_halo_edges(thalo.halo_partition_edges(
        src, dst, typ, n, slots, S, pad_to_multiple=8, halo_multiple=4), tmesh)
    gen = torch.Generator().manual_seed(1)
    xs = list(torch.randn(S * he.n_per, 5, generator=gen).split(he.n_per))
    w = torch.randn(slots, 5, 3, generator=gen)
    sends = [xs[s].index_select(0, sh.send_idx).view(S, he.halo, 5)
             for s, sh in enumerate(he.shards)]
    recvs = tring.halo_exchange_library(sends)
    from scaling_rgcn_training_tpu_torch.ops.span_kernels import (
        span_forward_plain)
    for s, sh in enumerate(he.shards):
        agg, buf = tfused.fused_halo_aggregate(xs, w, sh.fused)
        hbuf = recvs[s].reshape(S * he.halo, 5)
        torch.testing.assert_close(buf, hbuf, rtol=0, atol=0)
        want = (span_forward_plain(xs[s], w, sh.local.span)
                + span_forward_plain(hbuf, w, sh.halo.span))
        torch.testing.assert_close(agg, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["uniform", "hub"])
def test_send_transpose_sums_what_index_add_sums(tmesh, kind):
    """The send gather's transpose through the plan's CSR (a row shipped
    to several readers sums their cotangents in a fixed order) equals
    ``index_add`` over ``send_idx``; ``SendGather``'s gradient is it. The
    CSR leaves out exactly the padding slots, which no halo edge reads
    (their cotangents are zero)."""
    src, dst, typ, n, slots = _graph(kind)
    he = thalo.device_put_halo_edges(
        thalo.halo_partition_edges(src, dst, typ, n, slots, S), tmesh)
    h = he.halo
    gen = torch.Generator().manual_seed(1)
    for p, sh in enumerate(he.shards):
        rows = sh.send_idx.numel()
        shipped = [int(s * h + j) for s in range(S) for j in range(h)
                   if (he.hsrc[s][he.hnorm[s] > 0] == p * h + j).any()]
        assert sorted(sh.send_perm.tolist()) == shipped
        g = torch.zeros(rows, 6, dtype=torch.float64)
        g[shipped] = torch.randn(len(shipped), 6, generator=gen,
                                 dtype=torch.float64)
        want = torch.zeros(he.n_per, 6, dtype=torch.float64).index_add_(
            0, sh.send_idx, g)
        torch.testing.assert_close(tring.send_transpose(g, sh), want,
                                   rtol=1e-12, atol=1e-12)
        x = torch.randn(he.n_per, 6, generator=gen, dtype=torch.float64,
                        requires_grad=True)
        sent = thalo.SendGather.apply(x, sh)
        assert torch.equal(sent, x.detach()[sh.send_idx])
        sent.backward(g)
        torch.testing.assert_close(x.grad, want, rtol=1e-12, atol=1e-12)
        assert np.all(np.diff(sh.send_idx[sh.send_perm.long()].numpy()) >= 0)
