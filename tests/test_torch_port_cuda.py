"""The CUDA kernels (span, segment sum, grouped matmul and d_rhs) against
their plain PyTorch versions, on the card.

Needs a CUDA device and nvcc; skips without a card. Imports no jax (the
card's machine has none), so on the card run it without the JAX test
harness's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances: float32 rtol 1e-4 and atol 1e-4 * max|ref| (summation order
differs); bfloat16 inputs 2e-2 * max|ref|.
"""

import numpy as np
import pytest
import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.ops import grouped_kernels as gk
from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
from scaling_rgcn_training_tpu_torch.ops.segment_kernels import (
    segment_rowptr, sorted_segment_sum, sorted_segment_sum_plain)


def _graph(rng, n, e, slots):
    """Random edges; the last tenth of the nodes and every third relation
    get no edges."""
    live_rels = [r for r in range(slots) if r % 3 != 1]
    src = rng.integers(0, n - n // 10, e).astype(np.int32)
    dst = rng.integers(0, n - n // 10, e).astype(np.int32)
    rel = np.asarray(live_rels, np.int32)[rng.integers(0, len(live_rels), e)]
    norm = rng.random(e).astype(np.float32)
    return src, dst, rel, norm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out", [(63, 4), (24, 11), (11, 63), (64, 16),
                                        (128, 32)])
def test_cuda_kernels_match_plain(d_in, d_out, dtype, monkeypatch):
    """The CUDA kernels against their plain versions on the card, with
    several dW chunks per relation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(d_in * d_out)
    n, e, slots = 500, 4000, 30      # (128, 32) takes several W passes
    src, dst, rel, norm = _graph(rng, n, e, slots)
    monkeypatch.setattr(sk, "DW_CHUNK", 128)
    plan = sk.plan_span(src, dst, rel, norm, n, slots, device="cuda")
    dt = getattr(torch, dtype)
    x = torch.randn(n, d_in, device="cuda").to(dt)
    w = (torch.randn(slots, d_in, d_out, device="cuda") * 0.2).to(dt)
    g = torch.randn(n, d_out, device="cuda").to(dt)
    before = dict(sk.LAUNCHES)
    got = (sk.span_forward(x, w, plan), *sk.span_backward(g, x, w, plan))
    torch.cuda.synchronize()
    assert sk.LAUNCHES["span_forward"] == before["span_forward"] + 1
    assert sk.LAUNCHES["span_backward"] == before["span_backward"] + 1
    ref = (sk.span_forward_plain(x, w, plan), *sk.span_backward_plain(g, x, w, plan))
    for a, b in zip(got, ref):
        scale = float(b.abs().max())
        tol = dict(rtol=1e-4, atol=1e-4 * scale) if dtype == "float32" else \
            dict(rtol=0, atol=2e-2 * scale)
        torch.testing.assert_close(a, b, **tol)


def _tol(dtype, ref):
    scale = float(ref.abs().max())
    return dict(rtol=1e-4, atol=1e-4 * scale) if dtype == "float32" else \
        dict(rtol=0, atol=2e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [4, 8, 11, 16, 32, 64, 130])
def test_cuda_segment_sum_matches_plain(h, dtype):
    """Empty rows, one long row and rows of any width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(h)
    keys = np.sort(np.concatenate([rng.integers(0, 600, 3000) * 2,
                                   np.full(700, 901)])).astype(np.int32)
    rowptr = torch.tensor(segment_rowptr(keys, 1300)).cuda()
    vals = torch.randn(len(keys), h, device="cuda").to(getattr(torch, dtype))
    before = cuda_build.LAUNCHES["segment_sum"]
    got = sorted_segment_sum(vals, rowptr)
    again = sorted_segment_sum(vals, rowptr)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["segment_sum"] == before + 2
    assert torch.equal(got, again) and got.dtype == torch.float32
    ref = sorted_segment_sum_plain(vals, rowptr)
    torch.testing.assert_close(got, ref, **_tol(dtype, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(63, 4), (16, 8), (8, 16), (63, 11),
                                 (24, 32), (64, 16), (16, 64), (256, 64),
                                 (8, 130)])
def test_cuda_grouped_kernels_match_plain(k, n, dtype):
    """gmm and gmm_drhs with empty groups, groups spanning tiles and row
    counts that are not multiples of a tile, at every width class of the
    kernels' dispatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sizes = torch.tensor([0, 1500, 3, 0, 2049, 1, 0, 777], device="cuda")
    m, g = int(sizes.sum()), sizes.shape[0]
    dt = getattr(torch, dtype)
    lhs = torch.randn(m, k, device="cuda").to(dt)
    rhs = (torch.randn(g, k, n, device="cuda") * 0.2).to(dt)
    gout = torch.randn(m, n, device="cuda").to(dt)
    before = dict(cuda_build.LAUNCHES)
    out, drhs = gk.gmm(lhs, rhs, sizes), gk.gmm_drhs(lhs, gout, sizes)
    out2, drhs2 = gk.gmm(lhs, rhs, sizes), gk.gmm_drhs(lhs, gout, sizes)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["grouped_matmul"] == before["grouped_matmul"] + 2
    assert cuda_build.LAUNCHES["grouped_drhs"] == before["grouped_drhs"] + 2
    assert torch.equal(out, out2) and torch.equal(drhs, drhs2)
    assert out.dtype == dt and drhs.dtype == torch.float32
    ref = gk.gmm_plain(lhs, rhs, sizes)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype, ref.float()))
    ref = gk.gmm_drhs_plain(lhs, gout, sizes)
    torch.testing.assert_close(drhs, ref, **_tol(dtype, ref))
    assert not drhs[sizes.cpu() == 0].any()


@pytest.mark.cuda
def test_cuda_empty_shapes_launch_nothing():
    """Shapes with nothing to compute return at once and count no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = dict(cuda_build.LAUNCHES)
    sizes = torch.tensor([2, 3], device="cuda")
    assert not gk.gmm(torch.ones(5, 4, device="cuda"),
                      torch.ones(2, 4, 0, device="cuda"), sizes).numel()
    assert not gk.gmm_drhs(torch.ones(5, 0, device="cuda"),
                           torch.ones(5, 3, device="cuda"), sizes).numel()
    assert not sorted_segment_sum(
        torch.ones(0, 4, device="cuda"),
        torch.zeros(1, dtype=torch.int32, device="cuda")).numel()
    assert cuda_build.LAUNCHES == before
