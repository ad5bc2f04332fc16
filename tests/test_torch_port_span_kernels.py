"""Port span kernels against the JAX package's Pallas span kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas TPU interpret mode, as tests/test_span_kernels.py
runs them. Same inputs from one numpy seed. Tolerances: float32 rtol 2e-4
and atol 2e-4 * max|ref| (summation order differs); bfloat16 inputs 3e-2
(the TPU kernel rounds its products to bf16, the port sums in f32).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.ops.span_kernels import (
    plan_rel_span, rel_span_backward_scatter, rel_span_matmul_scatter)
from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import relational_aggregate


@pytest.fixture(autouse=True)
def interpret_mode():
    if jax.default_backend() != "tpu":
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            yield
    else:
        yield


def _graph(rng, n, e, slots):
    """Random edges; the last tenth of the nodes and every third relation
    get no edges."""
    live_rels = [r for r in range(slots) if r % 3 != 1]
    src = rng.integers(0, n - n // 10, e).astype(np.int32)
    dst = rng.integers(0, n - n // 10, e).astype(np.int32)
    rel = np.asarray(live_rels, np.int32)[rng.integers(0, len(live_rels), e)]
    norm = rng.random(e).astype(np.float32)
    return src, dst, rel, norm


DTYPES = [("float32", 2e-4, 2e-4), ("bfloat16", 3e-2, 3e-2)]
SHAPES = [
    (300, 2000, 7, 16, 8, 3),
    (300, 2000, 7, 24, 11, 3),    # d_out not a multiple of 8
    (100, 500, 3, 8, 16, 16),     # kspan > slots on the JAX side
]


def _pair(a, dtype):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.tensor(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype,rtol,atol", DTYPES)
@pytest.mark.parametrize("n,e,slots,d_in,d_out,k", SHAPES)
def test_span_forward_matches_jax(n, e, slots, d_in, d_out, k, dtype, rtol, atol):
    rng = np.random.default_rng(n + e + d_out)
    src, dst, rel, norm = _graph(rng, n, e, slots)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    w = (rng.standard_normal((slots, d_in, d_out)) * 0.2).astype(np.float32)

    span = plan_rel_span(src, dst, rel, norm, n, slots,
                         bucket_rows=64, chunk=128, kspan=k)
    vals = x[np.asarray(span.gather_idx)]
    ref = np.asarray(rel_span_matmul_scatter(
        _pair(vals, dtype)[0], span, _pair(w, dtype)[0]))

    plan = sk.plan_span(src, dst, rel, norm, n, slots)
    out = sk.span_forward(_pair(x, dtype)[1], _pair(w, dtype)[1], plan)
    assert out.dtype == torch.float32 and out.shape == (n, d_out)
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol,
                               atol=atol * np.abs(ref).max())
    assert not out[n - n // 10:].any()          # nodes without edges


@pytest.mark.parametrize("dtype,rtol,atol", DTYPES)
@pytest.mark.parametrize("n,e,slots,d_in,d_out,k", SHAPES)
def test_span_backward_matches_jax(n, e, slots, d_in, d_out, k, dtype, rtol, atol):
    rng = np.random.default_rng(2 * n + e + d_out)
    src, dst, rel, norm = _graph(rng, n, e, slots)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    w = (rng.standard_normal((slots, d_in, d_out)) * 0.2).astype(np.float32)
    g = rng.standard_normal((n, d_out)).astype(np.float32)

    span = plan_rel_span(dst, src, rel, norm, n, slots,
                         bucket_rows=64, chunk=128, kspan=k)
    t = g[np.asarray(span.gather_idx)]
    dx_ref, dw_ref = (np.asarray(a) for a in rel_span_backward_scatter(
        _pair(t, dtype)[0], span, _pair(x, dtype)[0], _pair(w, dtype)[0]))

    plan = sk.plan_span(src, dst, rel, norm, n, slots)
    dx, dw = sk.span_backward(_pair(g, dtype)[1], _pair(x, dtype)[1],
                              _pair(w, dtype)[1], plan)
    assert dx.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=rtol,
                               atol=atol * np.abs(dx_ref).max())
    np.testing.assert_allclose(dw.numpy(), dw_ref, rtol=rtol,
                               atol=atol * np.abs(dw_ref).max())
    assert not dw[1::3].any()                  # relations without edges


def test_plan_layouts(monkeypatch):
    """Each layout holds every edge once, in its sort order; dW chunks hold
    one relation each and at most ``DW_CHUNK`` edges."""
    rng = np.random.default_rng(5)
    n, e, slots, chunk = 120, 1500, 8, 64
    src, dst, rel, norm = _graph(rng, n, e, slots)
    monkeypatch.setattr(sk, "DW_CHUNK", chunk)
    plan = sk.plan_span(src, dst, rel, norm, n, slots)
    edges = sorted(zip(src.tolist(), dst.tolist(), rel.tolist(), norm.tolist()))

    def csr_edges(rowptr, other, rels, norms, row_is_dst):
        rowptr = rowptr.numpy()
        assert rowptr[0] == 0 and rowptr[-1] == e and (np.diff(rowptr) >= 0).all()
        out = []
        for row in range(n):
            lo, hi = rowptr[row], rowptr[row + 1]
            r = rels[lo:hi].numpy()
            assert (np.diff(r) >= 0).all()          # (row, rel) order
            for j in range(lo, hi):
                s, d = (int(other[j]), row) if row_is_dst else (row, int(other[j]))
                out.append((s, d, int(rels[j]), float(norms[j])))
        return sorted(out)

    assert csr_edges(plan.fwd_rowptr, plan.fwd_src, plan.fwd_rel,
                     plan.fwd_norm, True) == edges
    assert csr_edges(plan.bwd_rowptr, plan.bwd_dst, plan.bwd_rel,
                     plan.bwd_norm, False) == edges
    ptr, cptr = plan.rel_edge_ptr, plan.rel_chunk_ptr.numpy()
    lo, hi = plan.chunk_lo.numpy(), plan.chunk_hi.numpy()
    rel_edges = []
    for r in range(slots):
        covered = []
        for c in range(cptr[r], cptr[r + 1]):
            assert 0 < hi[c] - lo[c] <= chunk
            covered.extend(range(lo[c], hi[c]))
        assert covered == list(range(ptr[r], ptr[r + 1]))
        rel_edges += [(int(plan.rel_src[j]), int(plan.rel_dst[j]), r,
                       float(plan.rel_norm[j])) for j in covered]
    assert sorted(rel_edges) == edges


@pytest.mark.parametrize("bad", ["node", "relation", "length"])
def test_plan_rejects_bad_edges(bad):
    src, dst, rel = np.array([0, 1]), np.array([1, 2]), np.array([0, 1])
    norm = np.ones(2, np.float32)
    if bad == "node":
        dst = np.array([1, 3])
    elif bad == "relation":
        rel = np.array([0, 2])
    else:
        norm = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        sk.plan_span(src, dst, rel, norm, 3, 2)


def test_relational_aggregate_gradcheck():
    """The autograd Function's hand-written backward, in float64."""
    rng = np.random.default_rng(6)
    n, e, slots, d_in, d_out = 20, 90, 5, 4, 3
    src, dst, rel, norm = _graph(rng, n, e, slots)
    plan = sk.plan_span(src, dst, rel, norm, n, slots)
    x = torch.tensor(rng.standard_normal((n, d_in)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((slots, d_in, d_out)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: relational_aggregate(a, b, plan), (x, w))


def test_cpu_calls_launch_nothing_and_other_devices_raise():
    rng = np.random.default_rng(7)
    src, dst, rel, norm = _graph(rng, 30, 100, 4)
    plan = sk.plan_span(src, dst, rel, norm, 30, 4)
    x, w = torch.randn(30, 5), torch.randn(4, 5, 3)
    before = dict(sk.LAUNCHES)
    sk.span_forward(x, w, plan)
    sk.span_backward(torch.randn(30, 3), x, w, plan)
    assert sk.LAUNCHES == before
    with pytest.raises(ValueError):
        sk.span_forward(x.to("meta"), w.to("meta"), plan)


def test_failed_build_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(sk, "_BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        sk.build_kernels()
