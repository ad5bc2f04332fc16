"""Port sorted segment sum against the JAX package's Pallas segment sum.

On the CPU the port's wrapper runs its plain version (``index_add_`` in
float32); the JAX kernel runs in Pallas TPU interpret mode, as
tests/test_segment_kernels.py runs it. Same inputs from one numpy seed.
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
from scaling_rgcn_training_tpu_torch.ops.segment_kernels import (
    segment_rowptr, sorted_segment_sum, sorted_segment_sum_plain)


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
