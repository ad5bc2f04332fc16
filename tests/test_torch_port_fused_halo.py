"""Kernel #7 of the port (``parallel/fused_halo.py``) on the CPU: its plan,
its dataflow in PyTorch against its plain version, its bound's count, and
the port's fused halo conv against the JAX package's own #7.

The JAX side runs its one-kernel fused halo path
(``RGCN_HALO_PALLAS_A2A=fused``, ``RGCN_HALO_FUSED=1``) under the Pallas
TPU interpreter on 4 of the 8 virtual CPU devices (tests/conftest.py), as
``tests/test_fused_halo.py`` does; the port runs its fused mode on 4
virtual CPU shards, where #7 takes its plain version. Same graph and
inputs from one numpy seed. Tolerances: float32 within 1e-5 * max|ref|
(other summation order), bfloat16 edge streams within 2e-2 * max|ref|
(the packages round to bf16 at other places). The tiled plain and the
plain version both take exact products and float32 sums of the same
inputs, so they agree within 1e-5 * max|ref| in either dtype.
"""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.ops import init_rgcn_layer as j_init_layer
from scaling_rgcn_training_tpu.parallel import halo as jhalo
from scaling_rgcn_training_tpu.parallel.mesh import make_mesh as j_make_mesh
from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer
from scaling_rgcn_training_tpu_torch.parallel import fused_halo as fh
from scaling_rgcn_training_tpu_torch.parallel import halo as thalo
from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh, shard_rows


def _partition(s_n, seed=0, slots=7, chunk=None):
    """A halo partition of ``301 * s_n - 3`` nodes (``n_per`` not a multiple
    of 8) placed on ``s_n`` CPU shards, in which shard 1 (from 2 shards on)
    has no halo edges and the last shard ships no rows (nobody else reads
    it); ``halo_multiple=1``, so H is whatever the graph needs."""
    rng = np.random.default_rng(seed)
    n_nodes, e = 301 * s_n - 3, 2500 * s_n
    n_per = -(-n_nodes // s_n)
    dst = rng.integers(0, n_nodes, e)
    src = rng.integers(0, n_nodes, e)
    owner = dst // n_per
    if s_n >= 2:
        m = owner == 1
        src[m] = np.minimum(n_per + rng.integers(0, n_per, int(m.sum())),
                            n_nodes - 1)
        m = (src // n_per == s_n - 1) & (owner != s_n - 1)
        src[m] = rng.integers(0, n_per, int(m.sum()))
    typ = rng.integers(0, slots, e)
    he = thalo.halo_partition_edges(src, dst, typ, n_nodes, slots, s_n,
                                    pad_to_multiple=8, halo_multiple=1)
    return thalo.device_put_halo_edges(he, make_mesh(devices=("cpu",) * s_n))


@pytest.mark.parametrize("s_n", [1, 2, 4])
def test_fused_plan_chunks_cover_every_edge_once(s_n, monkeypatch):
    """The plan's relation chunks hold every edge of the shard once, each
    chunk at most ``DW_CHUNK`` edges of one relation, and ``fwd_pos`` maps
    the (dst, rel)-sorted CSR onto the relation order one to one."""
    monkeypatch.setattr(sk, "DW_CHUNK", 64)      # several chunks a relation
    he = _partition(s_n, seed=s_n)
    assert he.n_per % 8
    if s_n >= 2:
        assert he.shards[1].halo.num_edges == 0
        assert not he.send_idx[s_n - 1].any()
    for sh in he.shards:
        p = sh.fused
        e = p.src.numel()
        lo, hi = p.chunk_lo.numpy(), p.chunk_hi.numpy()
        ptr = p.rel_chunk_ptr.numpy()
        assert ptr[0] == 0 and ptr[-1] == p.num_chunks
        assert (hi > lo).all() and (hi - lo <= 64).all()
        covered = np.zeros(e, np.int64)
        rel_sorted = np.empty(e, np.int64)
        for r in range(p.num_slots):
            for c in range(ptr[r], ptr[r + 1]):
                covered[lo[c]:hi[c]] += 1
                rel_sorted[lo[c]:hi[c]] = r
        np.testing.assert_array_equal(covered, 1)
        pos = p.fwd_pos.numpy()
        np.testing.assert_array_equal(np.sort(pos), np.arange(e))
        # the CSR's edge j is the relation order's edge pos[j]
        np.testing.assert_array_equal(rel_sorted[pos], p.rel.numpy())
        np.testing.assert_array_equal(p.rel_src.numpy()[pos], p.src.numpy())
        np.testing.assert_array_equal(p.rel_norm.numpy()[pos],
                                      p.norm.numpy())
        assert p.fwd_rowptr is p.rowptr and p.num_nodes == p.n_per
        assert int(p.src.max()) < s_n * he.n_per


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out", [(63, 4), (11, 63)])
@pytest.mark.parametrize("s_n", [1, 2, 4])
def test_tiled_plain_matches_plain(s_n, d_in, d_out, dtype, monkeypatch):
    """``fused_halo_aggregate_tiled_plain`` (the kernel's dataflow: chunk
    messages in relation order, then each dst row's sum through
    ``fwd_pos``) against ``fused_halo_aggregate_plain`` on every shard,
    the halo buffers equal; on the CPU the wrapper and its earlier route
    run the plain version and launch nothing."""
    monkeypatch.setattr(sk, "DW_CHUNK", 64)
    he = _partition(s_n, seed=10 * s_n + d_in)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(d_in + d_out)
    xs = list(torch.randn(s_n * he.n_per, d_in, generator=gen).to(dt)
              .split(he.n_per))
    w = (torch.randn(he.num_slots, d_in, d_out, generator=gen) * 0.2).to(dt)
    before = dict(LAUNCHES)
    for sh in he.shards:
        ref, ref_buf = fh.fused_halo_aggregate_plain(xs, w, sh.fused)
        got, buf = fh.fused_halo_aggregate_tiled_plain(xs, w, sh.fused)
        assert got.dtype == torch.float32 and buf.dtype == dt
        assert buf.shape == (s_n * he.halo, d_in)
        torch.testing.assert_close(buf, ref_buf, rtol=0, atol=0)
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
        for fn in (fh.fused_halo_aggregate, fh.fused_halo_aggregate_rows):
            out, out_buf = fn(xs, w, sh.fused)
            torch.testing.assert_close(out, ref, rtol=0, atol=0)
            torch.testing.assert_close(out_buf, ref_buf, rtol=0, atol=0)
        assert fh.fused_halo_aggregate_tiled_plain(
            xs, w, sh.fused, want_buf=False)[1] is None
    assert LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_halo_cost_counts_the_function(dtype):
    """The bound's bytes: every shard's rows, w, the plan arrays the
    kernels read, the f32 aggregate and the halo buffer written (and
    ``recv_idx`` read), each once; operations 2 E d_in d_out, three times
    for float32 (3xTF32)."""
    he = _partition(4, seed=3)
    dt = getattr(torch, dtype)
    d_in, d_out = 16, 8
    xs = list(torch.zeros(4 * he.n_per, d_in, dtype=dt).split(he.n_per))
    w = torch.zeros(he.num_slots, d_in, d_out, dtype=dt)
    p = he.shards[2].fused
    e, size = p.src.numel(), w.element_size()
    plan_bytes = 4 * (3 * e + p.rowptr.numel() + 2 * p.num_chunks
                      + p.rel_chunk_ptr.numel())
    fixed = (4 * he.n_per * d_in * size + w.numel() * size + plan_bytes
             + 4 * he.n_per * d_out)
    ops = 2 * e * d_in * d_out
    unit = "tf32" if dtype == "float32" else "bfloat16"
    assert fh.fused_halo_cost(xs, w, p, want_buf=False) == (
        fixed, (3 if dtype == "float32" else 1) * ops, unit)
    n_bytes, _, _ = fh.fused_halo_cost(xs, w, p)
    assert n_bytes == fixed + 4 * p.recv_idx.numel() + \
        4 * he.halo * d_in * size


# -- the port's fused halo conv against the JAX package's own #7 ------------

S = 4
GRAPH_SEED, D, HL, N, E, R = 0, 8, 6, 53, 337, 4


def _graph():
    rng = np.random.default_rng(GRAPH_SEED)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    typ = rng.integers(0, 2 * R, E).astype(np.int32)
    x = rng.standard_normal((N, D)).astype(np.float32)
    gout = rng.standard_normal((N, HL)).astype(np.float32)
    return src, dst, typ, 2 * R + 1, x, gout


def _jax_fused_conv(src, dst, typ, slots, x, gout, params, compute_dtype):
    """The JAX halo conv through its one-kernel fused path (Pallas TPU
    interpreter): values and gradients of ``sum(out[:N] * gout)``."""
    from jax.experimental.pallas import tpu as pltpu

    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} virtual JAX devices")
    mesh = j_make_mesh(S)
    he = jhalo.device_put_halo_edges(jhalo.halo_partition_edges(
        src, dst, typ, N, slots, S, pad_to_multiple=8, halo_multiple=4), mesh)
    assert he.fplan is not None
    xp = jax.device_put(jhalo.pad_node_array(jnp.asarray(x), he),
                        jhalo.node_sharding(mesh))

    def f(p, xv):
        out = jhalo.halo_rgcn_conv(xv, he, p, mesh,
                                   compute_dtype=compute_dtype)
        return jnp.sum(out[:N] * jnp.asarray(gout)), out

    with warnings.catch_warnings():
        # a fallback from the one-kernel path warns: fail on it
        warnings.simplefilter("error", UserWarning)
        with pltpu.force_tpu_interpret_mode():
            (_, out), (gp, gx) = jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True)(params, xp)
    return [np.asarray(a, np.float32)
            for a in (out, gx, gp.weight, gp.root, gp.bias)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_halo_conv_matches_jax_fused_kernel(dtype, monkeypatch):
    """Values and gradients of the port's halo conv in fused mode (#7)
    against the JAX halo conv through the JAX package's own #7."""
    monkeypatch.setenv("RGCN_HALO_PALLAS_A2A", "fused")
    monkeypatch.setenv("RGCN_HALO_FUSED", "1")
    src, dst, typ, slots, x, gout = _graph()
    params = j_init_layer(jax.random.key(GRAPH_SEED), slots, D, HL)
    cd = None if dtype == "float32" else dtype
    ref = _jax_fused_conv(src, dst, typ, slots, x, gout, params,
                          cd and jnp.bfloat16)

    tmesh = make_mesh(devices=("cpu",) * S)
    he = thalo.device_put_halo_edges(thalo.halo_partition_edges(
        src, dst, typ, N, slots, S, pad_to_multiple=8, halo_multiple=4),
        tmesh)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    layer = RGCNLayer(t(params.weight), t(params.root), t(params.bias))
    xp = torch.zeros(thalo.padded_num_nodes(he), D)
    xp[:N] = torch.tensor(x)
    xp.requires_grad_(True)
    out = thalo.halo_rgcn_conv(shard_rows(xp, tmesh), he, layer, tmesh,
                               compute_dtype=cd and torch.bfloat16).gather()
    (out[:N] * torch.tensor(gout)).sum().backward()
    got = [out, xp.grad, layer.weight.grad, layer.root.grad, layer.bias.grad]
    frac = 1e-5 if dtype == "float32" else 2e-2
    for name, g, r in zip(("out", "dx", "dW", "droot", "dbias"), got, ref):
        g = g.detach().numpy()
        if name in ("out", "dx"):
            g, r = g[:N], r[:N]
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=frac * float(np.abs(r).max()),
                                   err_msg=name)


def test_fused_halo_backward_drops_each_halo_buffer():
    """#7's backward frees each shard's halo buffer once its shard is done
    (held through the reverse exchange, the buffers were the #7 step's
    peak above the library exchange's): the gradients are those of the
    library exchange's step, and a second backward of the same forward
    raises instead of reading a freed buffer."""
    he = _partition(4)
    tmesh = make_mesh(devices=("cpu",) * 4)
    rng = np.random.default_rng(7)
    slots, d_in, d_out = 7, 11, 5
    t = lambda *shape: torch.tensor(rng.standard_normal(shape),
                                    dtype=torch.float32)
    x0, w0, b = t(thalo.padded_num_nodes(he), d_in), t(slots, d_in, d_out), \
        t(d_in, d_out)
    grads = {}
    for mode in (None, "fused"):
        with pytest.MonkeyPatch.context() as mp:
            if mode is None:
                mp.delenv(thalo.EXCHANGE_ENV, raising=False)
            else:
                mp.setenv(thalo.EXCHANGE_ENV, mode)
            x = x0.clone().requires_grad_(True)
            layer = RGCNLayer(w0.clone(), b, torch.zeros(d_out))
            out = thalo.halo_rgcn_conv(shard_rows(x, tmesh), he, layer,
                                       tmesh).gather()
            out.square().sum().backward(retain_graph=True)
            grads[mode] = (x.grad.clone(), layer.weight.grad.clone())
            if mode == "fused":
                with pytest.raises(RuntimeError, match="runs once"):
                    out.square().sum().backward()
    for got, ref in zip(grads["fused"], grads[None]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
