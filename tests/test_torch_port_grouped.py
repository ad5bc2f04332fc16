"""Port grouped matmul and d_rhs against the JAX package's Pallas kernels.

On the CPU the port's ``"gather"`` backend and ``gmm_drhs`` run their plain
versions and ``"ragged"`` its per-group ``torch.matmul`` loop; the JAX
kernels (``grouped_matmul_pallas`` forward, ``_drhs``) run in Pallas TPU
interpret mode, as tests/test_pallas.py runs them. Same inputs from one
numpy seed, empty groups included. Tolerances: float32 rtol 1e-5 with atol
1e-5 * max|ref| (summation order differs); bfloat16 3e-2 * max|ref| (the
products are rounded to bf16 at other points).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.ops import pallas_kernels
from scaling_rgcn_training_tpu_torch.ops import grouped_kernels as gk
from scaling_rgcn_training_tpu_torch.ops.grouped_matmul import grouped_matmul


@pytest.fixture(autouse=True)
def interpret_mode():
    if jax.default_backend() != "tpu":
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            yield
    else:
        yield


def _case(seed, sizes, k, n):
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int32)
    m = int(sizes.sum())
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = (rng.standard_normal((len(sizes), k, n)) * 0.3).astype(np.float32)
    gout = rng.standard_normal((m, n)).astype(np.float32)
    offsets = tuple(int(v) for v in np.concatenate([[0], np.cumsum(sizes)]))
    return lhs, rhs, gout, sizes, offsets


CASES = [((0, 300, 0, 0, 212), 8, 4),       # empty groups, one spans tiles
         ((37, 0, 150, 91, 5, 0, 60), 63, 11)]
DTYPES = [("float32", 1e-5), ("bfloat16", 3e-2)]


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-6))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("sizes,k,n", CASES)
@pytest.mark.parametrize("backend", ["gather", "ragged", "pallas"])
def test_forward_matches_jax_pallas(backend, sizes, k, n, dtype, tol):
    lhs, rhs, _, sizes, offsets = _case(len(sizes) + k, sizes, k, n)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = pallas_kernels.grouped_matmul_pallas(
        jnp.asarray(lhs, jd), jnp.asarray(rhs, jd), jnp.asarray(sizes), offsets)
    got = grouped_matmul(torch.tensor(lhs).to(td), torch.tensor(rhs).to(td),
                         torch.tensor(sizes, dtype=torch.int64), backend=backend,
                         static_offsets=offsets)
    assert got.dtype == td and ref.dtype == jd   # lhs's dtype out
    _close(got, ref, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("sizes,k,n", CASES)
def test_drhs_matches_jax_pallas(sizes, k, n, dtype, tol):
    lhs, rhs, gout, sizes, offsets = _case(len(sizes) * k, sizes, k, n)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = pallas_kernels._drhs(jnp.asarray(lhs, jd), jnp.asarray(gout),
                               jnp.asarray(sizes), rhs.shape, tm=128,
                               static_offsets=offsets)
    got = gk.gmm_drhs(torch.tensor(lhs).to(td), torch.tensor(gout),
                      torch.tensor(sizes, dtype=torch.int64))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(got, ref, tol)
    assert not got[np.asarray(sizes) == 0].any()


def test_vjp_matches_jax_pallas():
    """The autograd Function's backward (gmm on rhs^T, gmm_drhs) against
    the JAX kernels' custom VJP."""
    lhs, rhs, gout, sizes, offsets = _case(3, (40, 0, 77, 13), 12, 6)

    def jloss(a, b):
        return jnp.sum(pallas_kernels.grouped_matmul_pallas(
            a, b, jnp.asarray(sizes), offsets) * gout)

    jl, jr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    tl = torch.tensor(lhs, requires_grad=True)
    tr = torch.tensor(rhs, requires_grad=True)
    out = gk.GroupedMatmul.apply(tl, tr, torch.tensor(sizes, dtype=torch.int64))
    (out * torch.tensor(gout)).sum().backward()
    _close(tl.grad, jl, 1e-5)
    _close(tr.grad, jr, 1e-5)


def test_grouped_matmul_function_gradcheck():
    rng = np.random.default_rng(4)
    sizes = torch.tensor([5, 0, 9, 3])
    lhs = torch.tensor(rng.standard_normal((17, 4)), requires_grad=True)
    rhs = torch.tensor(rng.standard_normal((4, 4, 3)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: gk.GroupedMatmul.apply(a, b, sizes), (lhs, rhs))


def test_backend_names_and_row_count_checked():
    lhs, rhs = torch.randn(10, 3), torch.randn(2, 3, 2)
    sizes = torch.tensor([4, 5])
    with pytest.raises(ValueError, match="rows"):
        grouped_matmul(lhs, rhs, sizes, backend="ragged")
    with pytest.raises(ValueError, match="unknown"):
        grouped_matmul(lhs, rhs, torch.tensor([4, 6]), backend="xla")
