"""The CUDA span kernels against their plain PyTorch versions, on the card.

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

from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk


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
