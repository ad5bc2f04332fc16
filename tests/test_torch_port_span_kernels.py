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
from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    plan_edges, relational_aggregate)


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


# the CUDA kernels' dataflow (span_forward_tiled_plain) in float32: rtol
# 1e-5, atol 1e-5 * max|ref|; in bfloat16 as DTYPES
TILED_DTYPES = [("float32", 1e-5, 1e-5), DTYPES[1]]


@pytest.mark.parametrize("dataflow,dtype,rtol,atol",
                         [("plain", *d) for d in DTYPES]
                         + [("tiled", *d) for d in TILED_DTYPES])
@pytest.mark.parametrize("n,e,slots,d_in,d_out,k", SHAPES)
def test_span_forward_matches_jax(n, e, slots, d_in, d_out, k, dtype, rtol,
                                  atol, dataflow, monkeypatch):
    """``span_forward`` (its plain version on the CPU) and, ``tiled``, the
    CUDA kernels' dataflow ``span_forward_tiled_plain`` over chunks of 100
    edges (a chunk's end inside a 64-edge tile) against the JAX kernel;
    the tiled dataflow also against ``span_forward_plain``."""
    rng = np.random.default_rng(n + e + d_out)
    src, dst, rel, norm = _graph(rng, n, e, slots)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    w = (rng.standard_normal((slots, d_in, d_out)) * 0.2).astype(np.float32)

    span = plan_rel_span(src, dst, rel, norm, n, slots,
                         bucket_rows=64, chunk=128, kspan=k)
    vals = x[np.asarray(span.gather_idx)]
    ref = np.asarray(rel_span_matmul_scatter(
        _pair(vals, dtype)[0], span, _pair(w, dtype)[0]))

    monkeypatch.setattr(sk, "DW_CHUNK", 100)
    plan = sk.plan_span(src, dst, rel, norm, n, slots)
    xt, wt = _pair(x, dtype)[1], _pair(w, dtype)[1]
    fwd = sk.span_forward if dataflow == "plain" else sk.span_forward_tiled_plain
    out = fwd(xt, wt, plan)
    assert out.dtype == torch.float32 and out.shape == (n, d_out)
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol,
                               atol=atol * np.abs(ref).max())
    assert not out[n - n // 10:].any()          # nodes without edges
    if dataflow == "tiled":
        plain = sk.span_forward_plain(xt, wt, plan)
        torch.testing.assert_close(out, plain, rtol=1e-5,
                                   atol=1e-5 * float(plain.abs().max()))


def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 mantissa bits), round to nearest even,
    as ``csrc/span_fwd_tc.cu`` ``tf32_round``."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    finite = (u & 0x7F800000) != 0x7F800000
    u = np.where(finite, u + 0xFFF + ((u >> 13) & 1), u) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def _grid_big(a: np.ndarray, axis: int, min_exp=-100) -> np.ndarray:
    """``a`` on the grid of 2^-10 times the power of two 2^e above its
    row's (``axis=1``) or column's (``axis=0``) largest |a|, e at least
    ``min_exp``, round to nearest even, in float32 as
    ``csrc/span_fwd_tc.cu`` ``Grid`` forms it (times 2^(10 - e), rounded,
    times 2^(e - 10))."""
    _, e = np.frexp(np.abs(a).max(axis=axis, keepdims=True))
    if min_exp is not None:
        e = np.maximum(e, min_exp)
    one = np.float32(1)
    with np.errstate(over="ignore", invalid="ignore"):
        inv = np.ldexp(one, 10 - e).astype(np.float32)
        return (np.rint(a * inv) * np.ldexp(one, e - 10)).astype(np.float32)


def _toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 to float32 rounded toward zero, as the tensor cores round
    the sums they form."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _split_product(a, b, a_big, b_big, small_small=True):
    """``a @ b`` from big and small parts as the kernel forms it, one mma
    per 8 of depth, each sum of the tensor cores cut toward zero: each
    step's big products, and its other products a_small b_big + a_big
    b_small + a_small b_small (without ``small_small``, 3xTF32: not the
    last), in fresh sums added in float32 (round to nearest)."""
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    small = np.zeros_like(acc)
    for k0 in range(0, a.shape[1], 8):
        sl = slice(k0, k0 + 8)
        f64 = lambda x, y: x[:, sl].astype(np.float64) @ y[sl].astype(np.float64)
        big = f64(a_big, b_big)
        cross = _toward_zero(f64(a_small, b_big))
        cross = _toward_zero(cross + f64(a_big, b_small))
        if small_small:
            cross = _toward_zero(cross + f64(a_small, b_small))
        acc += _toward_zero(big)
        small += cross
    return acc + small


@pytest.mark.parametrize("small_small", [False, True])
@pytest.mark.parametrize("k", [64, 128])
def test_split_tf32_keeps_float32_precision(k, small_small):
    """The f32 route's product: big parts on each row's (column's)
    fixed-point grid, small parts rounded to TF32, 3xTF32 a_big b_big +
    a_small b_big + a_big b_small (and the kernel's fourth product a_small
    b_small). Each step's big products sum exactly in float32, and the
    result is within rtol 1e-5 (atol 1e-5 * max|ref|) of the float64
    product, where one TF32 product is not."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((64, k)).astype(np.float32)
    b = (rng.standard_normal((k, 16)) * 0.2).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    a_big, b_big = _grid_big(a, 1), _grid_big(b, 0)
    for t in (a_big, b_big, _tf32(a - a_big), _tf32(b - b_big)):
        assert not (t.view(np.uint32) & 0x1FFF).any()   # 10 mantissa bits
    for k0 in range(0, k, 8):
        part = a_big[:, k0:k0 + 8].astype(np.float64) @ b_big[k0:k0 + 8]
        assert np.array_equal(part.astype(np.float32), part)   # exact
    got = _split_product(a, b, a_big, b_big, small_small)
    one = _toward_zero(_tf32(a).astype(np.float64) @ _tf32(b))
    limit = 1e-5 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    assert (np.abs(got - ref) <= limit).all()
    assert not (np.abs(one - ref) <= limit).all()


@pytest.mark.parametrize("k,m", [(64, 16), (16, 8)])
def test_split_tf32_fourth_product_cuts_the_error(k, m):
    """On the fixed-point grid a_small carries whole every value below
    2^-11 of its row's top, so a_small b_small is not negligible: the
    kernel's fourth product cuts the largest error of 3xTF32 by more than
    3x (on an H100 at the bench shape's layer 1: 5.6e-5 without it, 1.9e-5
    with it, and a training run's loss moved 3.7e-4 without it)."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((4096, k)).astype(np.float32)
    b = (rng.standard_normal((k, m)) * 0.2).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    a_big, b_big = _grid_big(a, 1), _grid_big(b, 0)
    three, four = (np.abs(_split_product(a, b, a_big, b_big, ss) - ref).max()
                   for ss in (False, True))
    assert four * 3 < three


@pytest.mark.parametrize("k,m", [(64, 16), (16, 8)])
def test_split_tf32_exact_big_parts_remove_the_bias(k, m):
    """Sums cut toward zero shrink the products of big parts tf32(a),
    tf32(b) (the split tried first: a signed error of about -4e-8 relative
    on the card, which moved a training run): every one of 16 draws of b
    is biased. With the big parts on the fixed-point grid their sums are
    exact, and the signed error averages to zero over the draws (each
    draw's is noise of the TF32 rounding left in the small parts, either
    way)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4096, k)).astype(np.float32)
    tf32_big, exact = [], []
    for _ in range(16):
        b = (rng.standard_normal((k, m)) * 0.2).astype(np.float32)
        ref = a.astype(np.float64) @ b.astype(np.float64)
        bias = lambda got: float(((got - ref) * np.sign(ref)).sum()
                                 / np.abs(ref).sum())
        tf32_big.append(bias(_split_product(a, b, _tf32(a), _tf32(b))))
        exact.append(bias(_split_product(a, b, _grid_big(a, 1),
                                         _grid_big(b, 0))))
    assert max(tf32_big) < -2e-8
    assert abs(np.mean(exact)) < 1e-8


def test_split_tf32_tiny_rows_stay_finite():
    """A row of a (a column of b) of values near 1e-37 has its top below
    2^-117: on its own grid 2^(10 - e) overflows float32, so its big parts
    are infinite (0 * inf: NaN); the grid's least exponent (``kMinTopExp``, -100) puts its values
    wholly into the small parts, and the product stays finite and within
    rtol 1e-5 of the float64 product."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((32, 64)).astype(np.float32)
    b = (rng.standard_normal((64, 16)) * 0.2).astype(np.float32)
    a[3] *= np.float32(1e-37)
    b[:, 5] *= np.float32(1e-37)
    assert not np.isfinite(_grid_big(a, 1, min_exp=None)[3]).any()
    a_big, b_big = _grid_big(a, 1), _grid_big(b, 0)
    assert not a_big[3].any() and not b_big[:, 5].any()
    got = _split_product(a, b, a_big, b_big)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert np.isfinite(got).all()
    limit = 1e-5 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    assert (np.abs(got - ref) <= limit).all()


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


@pytest.mark.parametrize("dtype,rtol,atol", TILED_DTYPES)
@pytest.mark.parametrize("n,e,slots,d_in,d_out,k", SHAPES)
def test_span_backward_tiled_matches_jax(n, e, slots, d_in, d_out, k, dtype,
                                         rtol, atol, monkeypatch):
    """The CUDA kernels' dataflow ``span_backward_tiled_plain`` (per chunk
    of 100 edges, a chunk's end inside a 16-edge tile: the dx messages into
    ``[E, d_in]`` and the dW partials, then the sum through ``bwd_pos`` and
    the chunk-ordered reduce) against the JAX kernel and against
    ``span_backward_plain``."""
    rng = np.random.default_rng(3 * n + e + d_out)
    src, dst, rel, norm = _graph(rng, n, e, slots)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    w = (rng.standard_normal((slots, d_in, d_out)) * 0.2).astype(np.float32)
    g = rng.standard_normal((n, d_out)).astype(np.float32)

    span = plan_rel_span(dst, src, rel, norm, n, slots,
                         bucket_rows=64, chunk=128, kspan=k)
    t = g[np.asarray(span.gather_idx)]
    refs = [np.asarray(a) for a in rel_span_backward_scatter(
        _pair(t, dtype)[0], span, _pair(x, dtype)[0], _pair(w, dtype)[0])]

    monkeypatch.setattr(sk, "DW_CHUNK", 100)
    plan = sk.plan_span(src, dst, rel, norm, n, slots)
    args = (_pair(g, dtype)[1], _pair(x, dtype)[1], _pair(w, dtype)[1], plan)
    got = sk.span_backward_tiled_plain(*args)
    assert [a.dtype for a in got] == [torch.float32] * 2
    assert got[0].shape == (n, d_in) and got[1].shape == (slots, d_in, d_out)
    for a, ref in zip(got, refs):
        np.testing.assert_allclose(a.numpy(), ref, rtol=rtol,
                                   atol=atol * np.abs(ref).max())
    assert not got[0][n - n // 10:].any()      # rows without edges
    assert not got[1][1::3].any()              # relations without edges
    for a, ref in zip(got, sk.span_backward_plain(*args)):
        torch.testing.assert_close(a, ref, rtol=rtol,
                                   atol=atol * float(ref.abs().max()))


def _dw_split(x, gn, chunk=1024, small_small=True):
    """``x^T gn`` over one relation's edges (``x [E, K]``, ``gn [E, M]``)
    as ``csrc/span_bwd_tc.cu`` forms dW in float32: per 16-edge tile (zero
    rows past the end) the product of A = x_tile^T and B = gn_tile from
    parts on the grid of each A row (a feature over the tile's edges) and
    of each B column (an output over the same edges), the edges as the
    depth (``_split_product``), added to the chunk's running sums in
    float32; the chunks' partials added in chunk order. Also returns
    whether every 8-edge step's big products summed exactly in float32."""
    e, k = x.shape
    dw, exact = np.zeros((k, gn.shape[1]), np.float32), True
    for c0 in range(0, e, chunk):
        run = np.zeros_like(dw)
        for t0 in range(c0, min(c0 + chunk, e), 16):
            n_e = min(16, c0 + chunk - t0, e - t0)
            a = np.zeros((k, 16), np.float32)
            b = np.zeros((16, dw.shape[1]), np.float32)
            a[:, :n_e], b[:n_e] = x[t0:t0 + n_e].T, gn[t0:t0 + n_e]
            a_big, b_big = _grid_big(a, 1), _grid_big(b, 0)
            for h in (slice(0, 8), slice(8, 16)):
                part = a_big[:, h].astype(np.float64) @ b_big[h]
                exact &= np.array_equal(part.astype(np.float32), part)
            run += _split_product(a, b, a_big, b_big, small_small)
        dw += run
    return dw, exact


def _relation_edges(rng, e=44_000, k=64, m=16):
    """One relation's gathered rows at layer 1 of the bench shape: ``x``
    rows and ``norm * g`` rows (mean norms of in-degree ~20)."""
    x = rng.standard_normal((e, k)).astype(np.float32)
    norm = (1.0 / rng.integers(5, 40, e)).astype(np.float32)
    gn = (rng.standard_normal((e, m)).astype(np.float32) * norm[:, None])
    return x, gn


@pytest.mark.parametrize("small_small", [False, True])
def test_split_tf32_dw_keeps_float32_precision(small_small):
    """#2's dW product over a relation of ~44,000 edges (the bench shape's
    mean) cut into 1,024-edge chunks: each 8-edge step's big products sum
    exactly, and the result, with 3 (3xTF32) or 4 products a multiply-add,
    is within rtol 1e-5 (atol 1e-5 * max|ref|) of the float64 product."""
    x, gn = _relation_edges(np.random.default_rng(11))
    ref = x.astype(np.float64).T @ gn.astype(np.float64)
    got, exact = _dw_split(x, gn, small_small=small_small)
    assert exact
    limit = 1e-5 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    assert (np.abs(got - ref) <= limit).all()


def test_split_tf32_dw_signed_error():
    """The signed error of #2's dW split (4 products) against float64,
    relative to the sum of |ref|, averages below 1e-8 over draws of a
    ~44,000-edge relation: the tensor cores' truncating sums cut no
    bias into dW's long sums."""
    rng = np.random.default_rng(12)
    biases = []
    for _ in range(4):
        x, gn = _relation_edges(rng)
        ref = x.astype(np.float64).T @ gn.astype(np.float64)
        got, _ = _dw_split(x, gn)
        biases.append(float(((got - ref) * np.sign(ref)).sum()
                            / np.abs(ref).sum()))
    assert abs(np.mean(biases)) < 1e-8


@pytest.mark.parametrize("num_src", [None, 150])
def test_plan_layouts(monkeypatch, num_src):
    """Each layout holds every edge once, in its sort order; dW chunks hold
    one relation each and at most ``DW_CHUNK`` edges; ``fwd_pos`` and
    ``bwd_pos`` map each edge of the forward and the src-sorted CSR to the
    same edge in relation order, and ``reverse_plan`` swaps them.
    ``num_src``: a rectangular plan (more source rows than dst rows)."""
    from scaling_rgcn_training_tpu_torch.ops.bwd_kernels import reverse_plan

    rng = np.random.default_rng(5)
    n, e, slots, chunk = 120, 1500, 8, 64
    src, dst, rel, norm = _graph(rng, n, e, slots)
    if num_src is not None:
        src = rng.integers(0, num_src, e).astype(np.int32)
    monkeypatch.setattr(sk, "DW_CHUNK", chunk)
    plan = sk.plan_span(src, dst, rel, norm, n, slots, num_src=num_src)
    edges = sorted(zip(src.tolist(), dst.tolist(), rel.tolist(), norm.tolist()))

    def csr_edges(rowptr, other, rels, norms, row_is_dst):
        rowptr = rowptr.numpy()
        assert rowptr[0] == 0 and rowptr[-1] == e and (np.diff(rowptr) >= 0).all()
        out = []
        for row in range(len(rowptr) - 1):
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

    # fwd_pos: a permutation of [0, E) from forward-CSR to relation order
    pos = plan.fwd_pos.numpy()
    assert plan.fwd_pos.dtype == torch.int32
    assert np.array_equal(np.sort(pos), np.arange(e))
    fwd_dst = np.repeat(np.arange(n), np.diff(plan.fwd_rowptr.numpy()))
    rel_rel = np.repeat(np.arange(slots), np.diff(ptr))
    assert np.array_equal(plan.rel_src.numpy()[pos], plan.fwd_src.numpy())
    assert np.array_equal(plan.rel_dst.numpy()[pos], fwd_dst)
    assert np.array_equal(rel_rel[pos], plan.fwd_rel.numpy())
    assert np.array_equal(plan.rel_norm.numpy()[pos], plan.fwd_norm.numpy())

    # bwd_pos: the same from the src-sorted CSR
    pos = plan.bwd_pos.numpy()
    assert plan.bwd_pos.dtype == torch.int32
    assert np.array_equal(np.sort(pos), np.arange(e))
    bwd_src = np.repeat(np.arange(plan.num_src), np.diff(plan.bwd_rowptr.numpy()))
    assert np.array_equal(plan.rel_src.numpy()[pos], bwd_src)
    assert np.array_equal(plan.rel_dst.numpy()[pos], plan.bwd_dst.numpy())
    assert np.array_equal(rel_rel[pos], plan.bwd_rel.numpy())
    assert np.array_equal(plan.rel_norm.numpy()[pos], plan.bwd_norm.numpy())

    rev = reverse_plan(plan)
    assert rev.fwd_pos is plan.bwd_pos and rev.bwd_pos is plan.fwd_pos
    assert np.array_equal(rev.rel_dst.numpy()[rev.fwd_pos.numpy()],
                          np.repeat(np.arange(rev.num_nodes),
                                    np.diff(rev.fwd_rowptr.numpy())))


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
    edges = plan_edges(src, dst, rel, norm, n, slots)
    x = torch.tensor(rng.standard_normal((n, d_in)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((slots, d_in, d_out)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: relational_aggregate(a, b, edges, "fused"), (x, w))


def test_cpu_calls_launch_nothing_and_other_devices_raise():
    rng = np.random.default_rng(7)
    src, dst, rel, norm = _graph(rng, 30, 100, 4)
    plan = sk.plan_span(src, dst, rel, norm, 30, 4)
    x, w = torch.randn(30, 5), torch.randn(4, 5, 3)
    g = torch.randn(30, 3)
    before = dict(sk.LAUNCHES)
    sk.span_forward(x, w, plan)
    dx, dw = sk.span_backward(g, x, w, plan)
    for route in (sk.span_backward_rows, sk.span_backward_tiled_plain):
        for a, b in zip(route(g, x, w, plan), (dx, dw)):
            torch.testing.assert_close(a, b)
    torch.testing.assert_close(sk.span_backward_half(g, x, w, plan, "dx"), dx)
    torch.testing.assert_close(sk.span_backward_half(g, x, w, plan, "dw"), dw)
    assert sk.LAUNCHES == before
    with pytest.raises(ValueError):
        sk.span_backward_half(g, x, w, plan, "both")
    with pytest.raises(ValueError):
        sk.span_forward(x.to("meta"), w.to("meta"), plan)


def test_failed_build_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build()
