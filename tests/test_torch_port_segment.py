"""Port sorted segment sum against the JAX package's Pallas segment sum.

On the CPU the port's wrapper runs its plain version (``index_add_`` in
float32); the JAX kernel runs in Pallas TPU interpret mode, as
tests/test_segment_kernels.py runs it. Same inputs from one numpy seed.
With ``perm`` and ``scale`` the JAX side takes the values into key order
and scales them first, as its ``ops/rgcn_conv.py`` does before the kernel.
Tolerances: float32 rtol 1e-6 with atol 1e-6 * max|ref| (summation order
differs); bfloat16 values, float32 result, 1e-2 * max|ref| (the TPU kernel
rounds its f32 one-hot product's inputs as the port does not).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.ops.segment_kernels import (
    plan_segmented_reduce, sorted_segment_sum_pallas)
from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.ops import rgcn_conv as tconv
from scaling_rgcn_training_tpu_torch.ops.segment_kernels import (
    segment_rowptr, sorted_segment_sum, sorted_segment_sum_plain,
    sorted_segment_sum_rows)


@pytest.fixture(autouse=True)
def interpret_mode():
    if jax.default_backend() != "tpu":
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            yield
    else:
        yield


def _keys(rng, kind, e, m):
    if kind == "random":        # many segments empty, some long
        return np.sort(rng.integers(0, m // 2, e) * 2).astype(np.int32)
    if kind == "one":           # every value in one segment
        return np.full(e, m // 3, np.int32)
    return np.sort(rng.integers(0, m, e)).astype(np.int32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("kind,e,m,h", [("random", 900, 300, 16),
                                        ("one", 700, 256, 8),
                                        ("dense", 2000, 100, 11)])
def test_segment_sum_matches_jax(kind, e, m, h, dtype, tol):
    rng = np.random.default_rng(e + m + h)
    keys = _keys(rng, kind, e, m)
    vals = rng.standard_normal((e, h)).astype(np.float32)
    plan = plan_segmented_reduce(keys, m, bucket_rows=64, chunk=128)
    ref = np.asarray(sorted_segment_sum_pallas(
        jnp.asarray(vals, getattr(jnp, dtype)), jnp.asarray(keys), plan))
    tvals = torch.tensor(vals).to(getattr(torch, dtype))
    rowptr = torch.tensor(segment_rowptr(keys, m))
    got = sorted_segment_sum(tvals, rowptr)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())
    empty = np.setdiff1d(np.arange(m), keys)
    assert (len(empty) == 0) == (kind == "dense")
    assert not got[empty].any()


def test_rowptr_and_cpu_path_launch_nothing():
    keys = np.array([0, 0, 2, 2, 2, 5], np.int32)
    np.testing.assert_array_equal(segment_rowptr(keys, 7),
                                  [0, 2, 2, 5, 5, 5, 6, 6])
    with pytest.raises(ValueError):
        segment_rowptr(keys[::-1], 7)
    with pytest.raises(ValueError):
        segment_rowptr(keys, 5)
    before = dict(cuda_build.LAUNCHES)
    vals = torch.randn(6, 3, dtype=torch.float64)
    out = sorted_segment_sum(vals, torch.tensor(segment_rowptr(keys, 7)))
    assert out.dtype == torch.float64 and cuda_build.LAUNCHES == before
    torch.testing.assert_close(out[2], vals[2:5].sum(0))
    with pytest.raises(ValueError):
        sorted_segment_sum_plain(vals, torch.tensor([[0, 6]], dtype=torch.int32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("gather", ["perm", "scale", "perm+scale"])
@pytest.mark.parametrize("kind,e,m,h", [("random", 900, 300, 16),
                                        ("one", 700, 256, 8),
                                        ("dense", 2000, 100, 11)])
def test_segment_sum_gather_matches_jax(kind, e, m, h, gather, dtype, tol):
    """``perm`` gathers the values into key order and ``scale`` (in the
    values' order) multiplies them: empty segments, one long segment, odd
    h."""
    rng = np.random.default_rng(e + m + h + len(gather))
    keys = _keys(rng, kind, e, m)
    vals = rng.standard_normal((e, h)).astype(np.float32)
    perm = (rng.permutation(e) if "perm" in gather else np.arange(e)
            ).astype(np.int32)
    scale = (rng.random(e).astype(np.float32) + 0.1 if "scale" in gather
             else np.ones(e, np.float32))
    plan = plan_segmented_reduce(keys, m, bucket_rows=64, chunk=128)
    jvals = jnp.take(jnp.asarray(vals, getattr(jnp, dtype)),
                     jnp.asarray(perm), axis=0)
    if "scale" in gather:
        jvals = jvals * jnp.take(jnp.asarray(scale), jnp.asarray(perm))[:, None]
    ref = np.asarray(sorted_segment_sum_pallas(jvals, jnp.asarray(keys), plan))
    tvals = torch.tensor(vals).to(getattr(torch, dtype))
    rowptr = torch.tensor(segment_rowptr(keys, m))
    kw = {"perm": torch.tensor(perm) if "perm" in gather else None,
          "scale": torch.tensor(scale) if "scale" in gather else None}
    before = dict(cuda_build.LAUNCHES)
    got = sorted_segment_sum(tvals, rowptr, **kw)
    assert got.dtype == torch.float32 and cuda_build.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())
    assert not got[np.setdiff1d(np.arange(m), keys)].any()
    # the earlier route takes the plain version on the CPU too
    torch.testing.assert_close(sorted_segment_sum_rows(tvals, rowptr, **kw),
                               got, rtol=0, atol=0)


def test_segment_sum_gather_rejects_bad_arguments():
    vals = torch.randn(6, 3)
    rowptr = torch.tensor([0, 2, 6], dtype=torch.int32)
    perm = torch.arange(6, dtype=torch.int32)
    for bad in ({"perm": perm.long()}, {"perm": perm[None]},
                {"scale": torch.ones(6, dtype=torch.float64)},
                {"scale": torch.ones(5)}):
        with pytest.raises(ValueError):
            sorted_segment_sum(vals, rowptr, **bad)
    # float64 (gradcheck): the scale multiplies in float64
    got = sorted_segment_sum(vals.double(), rowptr, perm=perm.flip(0),
                             scale=torch.full((6,), 0.5))
    assert got.dtype == torch.float64
    torch.testing.assert_close(got[0], 0.5 * vals[4:].double().sum(0))


@pytest.mark.parametrize("mode", ["edge", "prematmul"])
def test_edge_aggregate_gathers_no_messages(mode, monkeypatch):
    """The edge and prematmul dataflows hand the message stream to the
    segment sum with its permutation (and the forward with ``norm``), and
    never gather ``[E, h]`` rows themselves."""
    rng = np.random.default_rng(5)
    n, e, slots, d_in, d_out = 40, 500, 5, 6, 3
    src, dst = (rng.integers(0, n, e).astype(np.int32) for _ in range(2))
    typ = rng.integers(0, slots, e).astype(np.int32)
    edges = tconv.build_rel_edges(src, dst, typ, n, slots, span=False)
    calls, gathered = [], []
    real_sum, real_select = tconv.sorted_segment_sum, torch.Tensor.index_select

    def spy_sum(vals, rowptr, perm=None, scale=None):
        # the plain version's own gathers (the CPU's stand-in for the
        # kernel's reads) are not the dataflow's
        calls.append((tuple(vals.shape), perm, scale))
        monkeypatch.setattr(torch.Tensor, "index_select", real_select)
        try:
            return real_sum(vals, rowptr, perm=perm, scale=scale)
        finally:
            monkeypatch.setattr(torch.Tensor, "index_select", spy_select)

    def spy_select(self, dim, index):
        gathered.append(self.shape[0])
        return real_select(self, dim, index)

    monkeypatch.setattr(tconv, "sorted_segment_sum", spy_sum)
    monkeypatch.setattr(torch.Tensor, "index_select", spy_select)
    layer = tconv.init_rgcn_layer(torch.Generator().manual_seed(0), slots,
                                  d_in, d_out)
    x = torch.randn(n, d_in, requires_grad=True)
    out = tconv.relational_aggregate(x, tconv.materialize_weight(layer),
                                     edges, mode)
    out.sum().backward()
    assert [c[0] for c in calls] == [(e, d_out), (e, d_in)]
    (_, fperm, fscale), (_, bperm, bscale) = calls
    assert fperm is edges.dst_perm and fscale is edges.norm
    assert bperm is edges.src_perm and bscale is None
    assert gathered and e not in gathered
