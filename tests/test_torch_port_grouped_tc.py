"""The tensor-core routes of the grouped matmul (#4, ``gmm_tc_kernel``) and
its d_rhs (#5, ``drhs_tc_kernel``) on the CPU.

Their dataflows in PyTorch (``gmm_tiled_plain``: row tiles, the groups each
tile meets, depth chunks; ``gmm_drhs_tiled_plain``: the (row tile, group)
partials, the staircase and its reduce order) against the plain versions
and the JAX package's Pallas kernels (``_fwd`` and ``_drhs``, in Pallas TPU
interpret mode as tests/test_pallas.py runs them), over groups that
straddle 16-row and 1,024-row tile edges, empty groups at the start, the
middle and the end, row counts off the tiles and widths 4, 11, 63 and
256 x 64. Same inputs from one numpy seed; tolerances as
tests/test_torch_port_grouped.py states them: float32 rtol 1e-5 with atol
1e-5 * max|ref|, bfloat16 3e-2 * max|ref|.

The float32 products of both kernels are split TF32 products on
fixed-point grids; their arithmetic is emulated in numpy with the helpers
of tests/test_torch_port_span_kernels.py and held against float64.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.ops import pallas_kernels
from scaling_rgcn_training_tpu_torch.ops import grouped_kernels as gk
from tests.test_torch_port_grouped import DTYPES, _close
from tests.test_torch_port_span_kernels import _grid_big, _split_product


@pytest.fixture(autouse=True)
def interpret_mode():
    if jax.default_backend() != "tpu":
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            yield
    else:
        yield


# group sizes, K, N: empty groups at the start, in the middle and at the
# end; groups across 16-row and 1,024-row tile edges; M = 4,330, 2,071 and
# 1,041 rows (no multiple of 16); widths 4, 11, 63 and 256 x 64 (past
# GMM_DEPTH for float32 and past one 64-wide output tile)
CASES = [((0, 1500, 3, 0, 2049, 1, 0, 777, 0), 63, 11),
         ((17, 0, 0, 2050, 4), 4, 4),
         ((1030, 0, 11), 11, 63),
         ((5, 0, 300, 736), 256, 64)]


def _case(seed, sizes, k, n, dtype):
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int32)
    m = int(sizes.sum())
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = (rng.standard_normal((len(sizes), k, n)) * 0.3).astype(np.float32)
    gout = rng.standard_normal((m, n)).astype(np.float32)
    td = getattr(torch, dtype)
    port = (torch.tensor(lhs).to(td), torch.tensor(rhs).to(td),
            torch.tensor(gout).to(td), torch.tensor(sizes, dtype=torch.int64))
    jd = getattr(jnp, dtype)
    jaxs = (jnp.asarray(lhs, jd), jnp.asarray(rhs, jd), jnp.asarray(gout, jd),
            jnp.asarray(sizes))
    return port, jaxs


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("sizes,k,n", CASES)
def test_gmm_tiled_plain_matches_plain_and_jax(sizes, k, n, dtype, tol):
    (lhs, rhs, _, sz), (jl, jr, _, js) = _case(k * n, sizes, k, n, dtype)
    got = gk.gmm_tiled_plain(lhs, rhs, sz)
    assert got.dtype == lhs.dtype
    plain = gk.gmm_plain(lhs, rhs, sz)
    _close(got, plain.float().numpy(), tol)
    _close(got, pallas_kernels._fwd(jl, jr, js), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("sizes,k,n", CASES)
def test_drhs_tiled_plain_matches_plain_and_jax(sizes, k, n, dtype, tol):
    (lhs, _, gout, sz), (jl, _, jg, js) = _case(k + n, sizes, k, n, dtype)
    got = gk.gmm_drhs_tiled_plain(lhs, gout, sz)
    assert got.dtype == torch.float32 and got.shape == (len(sizes), k, n)
    _close(got, gk.gmm_drhs_plain(lhs, gout, sz).numpy(), tol)
    ref = pallas_kernels._drhs(jl, jg, js, (len(sizes), k, n), tm=512)
    _close(got, ref, tol)
    assert not got[np.asarray(sizes) == 0].any()


@pytest.mark.parametrize("rows", [256, 4096])
def test_gmm_tiled_plain_does_not_depend_on_the_row_tile(monkeypatch, rows):
    """Each row's product reads only its own row and its group's rhs, so the
    kernel's row tile (``GMM_TILE_ROWS``) moves no bit: the same output at
    another tile height."""
    (lhs, rhs, _, sz), _ = _case(5, CASES[0][0], 63, 11, "float32")
    ref = gk.gmm_tiled_plain(lhs, rhs, sz)
    monkeypatch.setattr(gk, "GMM_TILE_ROWS", rows)
    assert torch.equal(gk.gmm_tiled_plain(lhs, rhs, sz), ref)


def test_gmm_tiled_plain_rows_past_the_groups_are_zero():
    """Group sizes that sum to less than M: the rows past the last group
    come out 0, as from the JAX kernel (which zeroes its output tile)."""
    (lhs, rhs, _, _), (jl, jr, _, _) = _case(6, (400, 0, 300), 24, 16,
                                             "float32")
    sizes = (300, 0, 100)
    got = gk.gmm_tiled_plain(lhs, rhs, torch.tensor(sizes))
    assert not got[400:].any()
    _close(got, pallas_kernels._fwd(jl, jr, jnp.asarray(sizes, jnp.int32)),
           1e-5)


def test_gmm_tiled_plain_depth_chunks_add_in_order():
    """Past ``GMM_DEPTH`` features the product is the depth chunks' float32
    partials added in chunk order: bit for bit that sum."""
    (lhs, rhs, _, sz), _ = _case(7, (100, 0, 60), 300, 8, "float32")
    depth = gk.GMM_DEPTH[torch.float32]
    got = gk.gmm_tiled_plain(lhs, rhs, sz)
    offs = [0, 100, 100, 160]
    for g in range(3):
        a, b = offs[g], offs[g + 1]
        want = sum((lhs[a:b, k0:k0 + depth] @ rhs[g, k0:k0 + depth]
                    for k0 in range(0, 300, depth)), torch.zeros(b - a, 8))
        assert torch.equal(got[a:b], want)


# -- the float32 split, emulated ----------------------------------------------

def _drhs_split(lhs, gout, sizes, tile_rows=gk.DRHS_TILE_ROWS):
    """``gmm_drhs`` in float32 as ``drhs_tc_kernel`` forms it for an output
    tile whose warps each own their tiles (split 1): per (row tile, group)
    pair, its rows from the group's first in 16-row tiles (zero rows past
    the pair), each tile's x^T g from parts on the grid of each A row (a
    feature over the tile's rows) and of each B column (an output over the
    same rows) with the rows as the depth (``_split_product``, #2's dW),
    added to the pair's running sums in float32; each group's partials
    added in row-tile order."""
    k, n = lhs.shape[1], gout.shape[1]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    out = np.zeros((len(sizes), k, n), np.float32)
    for g, (lo, hi) in enumerate(zip(offs[:-1], offs[1:])):
        for i in range(lo // tile_rows, -(-hi // tile_rows)):
            a0, b0 = max(lo, i * tile_rows), min(hi, (i + 1) * tile_rows)
            run = np.zeros((k, n), np.float32)
            for t0 in range(a0, b0, 16):
                rows = min(16, b0 - t0)
                a = np.zeros((k, 16), np.float32)
                b = np.zeros((16, n), np.float32)
                a[:, :rows], b[:rows] = lhs[t0:t0 + rows].T, gout[t0:t0 + rows]
                run += _split_product(a, b, _grid_big(a, 1), _grid_big(b, 0))
            out[g] += run
    return out


def _by_group(fn, lhs, gout, sizes):
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return np.stack([fn(lhs[a:b].astype(np.float64)).T
                     @ fn(gout[a:b].astype(np.float64))
                     for a, b in zip(offs[:-1], offs[1:])])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drhs_split_keeps_float32_precision_from_1e_37_up(seed):
    """#5's float32 d_rhs over rows whose scales run log-uniform from 1e-37
    to 1, mixed within each 16-row tile, at layer 1's widths (64 x 16):
    within 1e-6 of the float64 product relative to |lhs|^T |gout| (the sum
    of the terms' magnitudes: a term's error is relative to itself, whatever
    the others cancel), and within 1e-6 of each group's largest |ref|. A
    row far below its tile's top goes wholly to the small parts; a tile
    whose rows all lie below the grids' floor keeps TF32's precision only
    (next test), so every tile here holds a row above it (groups of 777
    rows and more: all of a tile's 12 or more draws below 1e-30 has odds
    under 1e-8)."""
    rng = np.random.default_rng(seed)
    sizes = np.array([0, 1500, 0, 2049, 777, 0])
    m = int(sizes.sum())
    scale = 10.0 ** -rng.uniform(0, 37, m)
    lhs = (rng.standard_normal((m, 64)) * scale[:, None]).astype(np.float32)
    gout = rng.standard_normal((m, 16)).astype(np.float32)
    got = _drhs_split(lhs, gout, sizes)
    ref = _by_group(lambda a: a, lhs, gout, sizes)
    err = np.abs(got - ref)
    assert (err <= 1e-6 * _by_group(np.abs, lhs, gout, sizes)).all()
    for g in np.flatnonzero(sizes):
        assert err[g].max() <= 1e-6 * np.abs(ref[g]).max()


def test_drhs_split_below_the_grid_floor_keeps_tf32_precision():
    """A group whose rows all lie below the grids' floor (2^-100, about
    7.9e-31: span_tc.cuh ``kMinTopExp``) has every value in the small parts,
    rounded to TF32: finite, and within 2^-10 of float64 relative to the
    group's largest |ref|, not 1e-6. The same holds for #2's dW (the same
    grids); rows from 1e-30 up keep float32's precision (above)."""
    rng = np.random.default_rng(3)
    sizes = np.array([700, 500])
    lhs = rng.standard_normal((1200, 64)).astype(np.float32)
    lhs[:700] *= np.float32(1e-37)
    lhs[700:] *= np.float32(1e-30)
    gout = rng.standard_normal((1200, 16)).astype(np.float32)
    got = _drhs_split(lhs, gout, sizes)
    ref = _by_group(lambda a: a, lhs, gout, sizes)
    assert np.isfinite(got).all()
    rel = [np.abs(got[g] - ref[g]).max() / np.abs(ref[g]).max()
           for g in range(2)]
    assert 1e-6 < rel[0] <= 2.0 ** -10
    assert rel[1] <= 1e-6


def test_drhs_split_signed_error():
    """The signed error of #5's float32 split against float64, relative to
    the sum of |ref|, averages below 1e-8 over draws at layer 1's widths
    (chip_smoke.py holds the card's to 1e-8 at the bench shape)."""
    rng = np.random.default_rng(4)
    sizes = np.array([1500, 2049, 777])
    biases = []
    for _ in range(4):
        lhs = rng.standard_normal((4326, 64)).astype(np.float32)
        gout = (rng.standard_normal((4326, 16)) / 20).astype(np.float32)
        got = _drhs_split(lhs, gout, sizes)
        ref = _by_group(lambda a: a, lhs, gout, sizes)
        biases.append(float(((got - ref) * np.sign(ref)).sum()
                            / np.abs(ref).sum()))
    assert abs(np.mean(biases)) < 1e-8


def test_gmm_split_keeps_float32_precision_from_1e_30_up():
    """#4's float32 product (``tile_times_staged``: each lhs row on its own
    grid over its K values, each rhs column on its own grid over K, four
    products a multiply-add) over rows with scales log-uniform from 1e-30
    to 1: within 1e-6 of float64 relative to |lhs| |rhs| per element."""
    rng = np.random.default_rng(5)
    scale = 10.0 ** -rng.uniform(0, 30, 2000)
    lhs = (rng.standard_normal((2000, 64)) * scale[:, None]).astype(np.float32)
    w = (rng.standard_normal((64, 16)) * 0.2).astype(np.float32)
    got = np.concatenate([
        _split_product(lhs[r:r + 16], w, _grid_big(lhs[r:r + 16], 1),
                       _grid_big(w, 0)) for r in range(0, 2000, 16)])
    ref = lhs.astype(np.float64) @ w.astype(np.float64)
    mag = np.abs(lhs.astype(np.float64)) @ np.abs(w.astype(np.float64))
    assert (np.abs(got - ref) <= 1e-6 * mag).all()
