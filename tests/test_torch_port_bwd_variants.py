"""Kernel #8's plain versions, its bucket plan and the attribution
microbench, on the CPU.

The variants' plain versions (``ops/bwd_kernels.py``, both routes) against
the JAX package's one-pass backward span kernel
``rel_span_backward_scatter``, run in Pallas TPU interpret mode as
``tests/test_span_kernels.py`` runs it; the TPU microbench script itself
builds a 4M-edge graph when imported, so the kernel it times is reached
through the package. Same inputs from one numpy seed, empty relations and
rows without edges. Tolerances: float32 rtol 1e-5 with atol 1e-5 *
max|ref| (summation order differs); bfloat16 inputs rtol and atol 3e-2 *
max|ref|, as in ``test_torch_port_span_kernels.py`` (the TPU kernel rounds
its products to bf16, the port sums in f32); the ``tf32`` variant's
rounded operands, the TF32 bound below.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.ops.span_kernels import (
    plan_rel_span, rel_span_backward_scatter)
from scaling_rgcn_training_tpu_torch import bwd_variants
from scaling_rgcn_training_tpu_torch.ops import bwd_kernels as bk
from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk


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


DTYPES = [("float32", 1e-5, 1e-5), ("bfloat16", 3e-2, 3e-2)]
SHAPES = [(63, 4), (11, 63), (16, 8)]


def _jax_backward(src, dst, rel, norm, n, slots, x, w, g, dtype):
    """``(dx, dw)`` of the JAX kernel on these edges."""
    span = plan_rel_span(dst, src, rel, norm, n, slots, bucket_rows=64,
                         chunk=128, kspan=3)
    jt = lambda a: jnp.asarray(a, getattr(jnp, dtype))
    dx, dw = rel_span_backward_scatter(jt(g[np.asarray(span.gather_idx)]),
                                       span, jt(x), jt(w))
    return np.asarray(dx), np.asarray(dw)


def _close(got, ref, rtol, atol):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=atol * np.abs(ref).max())


@pytest.mark.parametrize("dtype,rtol,atol", DTYPES)
@pytest.mark.parametrize("d_in,d_out", SHAPES)
@pytest.mark.parametrize("variant", ["base", "nodw", "nodx", "statrmw",
                                     "noonehot", "fwdrev", "simt"])
def test_variant_plain_matches_jax(variant, d_in, d_out, dtype, rtol, atol):
    """Each row's plain version against the JAX kernel: the redesign's
    ``base`` and ``nodw``/``nodx`` (the one half) over the bucket plan,
    the earlier route's ``simt`` (its base) and ``statrmw`` (dx and each
    relation pass's dW summed into its first slot), ``noonehot`` ``base``
    on edges with ``dst`` folded into a window, ``fwdrev`` the forward over
    the reversed plan with W^T."""
    n, e, slots = 300, 2000, 7
    rng = np.random.default_rng(d_in * 100 + d_out)
    src, dst, rel, norm = _graph(rng, n, e, slots)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    w = (rng.standard_normal((slots, d_in, d_out)) * 0.2).astype(np.float32)
    g = rng.standard_normal((n, d_out)).astype(np.float32)
    plan = sk.plan_span(src, dst, rel, norm, n, slots)
    if variant == "noonehot":
        window = 37
        plan = bk.fold_dst(plan, window)
        dst = dst % window
    dx_ref, dw_ref = _jax_backward(src, dst, rel, norm, n, slots, x, w, g,
                                   dtype)
    tt = lambda a: torch.tensor(a).to(getattr(torch, dtype))
    if variant == "fwdrev":
        wt = tt(w).transpose(1, 2).contiguous()
        _close(sk.span_forward_rows(tt(g), wt, bk.reverse_plan(plan)),
               dx_ref, rtol, atol)
        return
    v = "base" if variant in ("noonehot", "simt") else variant
    if variant in ("simt", "statrmw"):
        dx, dw = bk.span_backward_variant_simt(tt(g), tt(x), tt(w), plan, v)
    else:
        dx, dw = bk.span_backward_variant(tt(g), tt(x), tt(w),
                                          bk.plan_buckets(plan, 32), v)
    assert (dx is None) == (v == "nodx") and (dw is None) == (v == "nodw")
    if dx is not None:
        assert dx.shape == (n, d_in)
        _close(dx, dx_ref, rtol, atol)
        assert not dx[n - n // 10:].any()          # rows without edges
    if v == "statrmw":
        step = bk.pass_rels("statrmw", getattr(torch, dtype), d_in, d_out,
                            slots)
        stat = np.zeros_like(dw_ref)
        for r_lo in range(0, slots, step):
            stat[r_lo] = dw_ref[r_lo:r_lo + step].sum(0)
        dw_ref = stat
    if dw is not None:
        assert dw.shape == (slots, d_in, d_out)
        _close(dw, dw_ref, rtol, atol)
        if v != "statrmw":
            assert not dw[1::3].any()              # relations without edges


@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_tf32_plain_matches_jax(d_in, d_out):
    """The ``tf32`` variant's plain version (float32 inputs, the operands
    ``norm * g``, ``x`` and ``w`` rounded to TF32, summed in float32)
    against the JAX kernel in float32. TF32 keeps 10 mantissa bits, so a
    rounded operand is off by at most 2^-11 of itself and a product of two
    by at most 2^-10 + 2^-22 of itself: every element stays within 1.01 *
    2^-10 of the sum of its terms' magnitudes (the same sums over |norm
    g|, |x| and |w|), plus the float32 tolerance above for the order of
    the sums."""
    n, e, slots = 300, 2000, 7
    rng = np.random.default_rng(d_in * 100 + d_out)
    src, dst, rel, norm = _graph(rng, n, e, slots)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    w = (rng.standard_normal((slots, d_in, d_out)) * 0.2).astype(np.float32)
    g = rng.standard_normal((n, d_out)).astype(np.float32)
    plan = sk.plan_span(src, dst, rel, norm, n, slots)
    refs = _jax_backward(src, dst, rel, norm, n, slots, x, w, g, "float32")
    got = bk.span_backward_variant(torch.tensor(g), torch.tensor(x),
                                   torch.tensor(w), bk.plan_buckets(plan),
                                   "tf32")
    mags = [t.numpy() for t in sk.span_backward_plain(
        torch.tensor(np.abs(g), dtype=torch.float64),
        torch.tensor(np.abs(x), dtype=torch.float64),
        torch.tensor(np.abs(w), dtype=torch.float64), plan)]
    for a, ref, mag in zip(got, refs, mags):
        err = np.abs(a.numpy().astype(np.float64) - ref)
        limit = 1.01 * 2.0**-10 * mag + 1e-5 * np.abs(ref).max()
        assert (err <= limit).all(), float((err - limit).max())
        # the rounding shows: not the float32 version
        assert err.max() > 1e-6 * np.abs(ref).max()


def test_tf32_round():
    """``tf32_round`` keeps 10 mantissa bits, rounds to nearest with ties
    to even, and keeps infinities, NaNs and signed zeros."""
    rng = np.random.default_rng(5)
    v = (rng.standard_normal(10000) * 10.0 ** rng.integers(-30, 30, 10000)
         ).astype(np.float32)
    r = bk.tf32_round(torch.tensor(v)).numpy()
    assert (r.view(np.int32) & 0x1FFF == 0).all()
    assert (np.abs(r.astype(np.float64) - v) <= 2.0**-11 * np.abs(v)).all()
    one = np.float32(1.0)
    ties = np.array([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11)], np.float32)
    assert bk.tf32_round(torch.tensor(ties)).tolist() == [
        one, 1 + 2 * 2**-10, -one]
    special = torch.tensor([np.inf, -np.inf, np.nan, -0.0,
                            np.finfo(np.float32).max],
                           dtype=torch.float32)
    r = bk.tf32_round(special)
    assert r[0] == np.inf and r[1] == -np.inf and torch.isnan(r[2])
    assert str(r[3].item()) == "-0.0" and r[4] == np.inf


@pytest.mark.parametrize("bucket_rows", [1, 7, 64, 512])
def test_plan_buckets(bucket_rows):
    """The bucket plan is a permutation of the plan's edges; its offsets
    bound each (bucket, relation) segment, whose edges are that bucket's
    and relation's, sorted by src; and every src row meets its edges in
    the src-sorted CSR's order (relation, then the CSR's ties)."""
    rng = np.random.default_rng(bucket_rows)
    n, e, slots = 130, 1500, 5
    src, dst, rel, norm = _graph(rng, n, e, slots)
    norm = np.arange(e, dtype=np.float32)      # tells the edges apart
    plan = sk.plan_span(src, dst, rel, norm, n, slots)
    bp = bk.plan_buckets(plan, bucket_rows)
    nb = -(-n // bucket_rows)
    assert bp.num_buckets == nb and bp.bucket_rows == bucket_rows
    assert bp.row.dtype == torch.int16 and bp.dst.dtype == torch.int32
    seg = bp.seg_ptr.numpy()
    assert seg.shape == (nb * slots + 1,) and seg[0] == 0 and seg[-1] == e
    assert (np.diff(seg) >= 0).all()
    ids = bp.norm.numpy().astype(np.int64)
    assert np.array_equal(np.sort(ids), np.arange(e))
    b_src = np.repeat(np.arange(nb * slots) // slots, np.diff(seg)) \
        * bucket_rows + bp.row.numpy()
    b_rel = np.repeat(np.arange(nb * slots) % slots, np.diff(seg))
    assert np.array_equal(b_src, src[ids]) and np.array_equal(b_rel, rel[ids])
    assert np.array_equal(bp.dst.numpy(), dst[ids])
    assert (bp.row.numpy() >= 0).all() and (bp.row.numpy() < bucket_rows).all()
    for s_lo, s_hi in zip(seg[:-1], seg[1:]):
        assert (np.diff(b_src[s_lo:s_hi]) >= 0).all()
    csr_src, _, _, csr_norm = bk.plan_edge_arrays(plan)
    for v in range(n):
        assert np.array_equal(ids[b_src == v],
                              csr_norm[csr_src == v].astype(np.int64))


@pytest.mark.parametrize("variant,dtype,d_in,d_out,slots,expected", [
    ("base", torch.float32, 64, 16, 91, 23),       # 8 KB a relation, 4 passes
    ("nodw", torch.float32, 64, 16, 91, 46),       # W^T only: 2 passes
    ("nodx", torch.bfloat16, 64, 16, 91, 46),      # dW only (f32)
    ("base", torch.bfloat16, 64, 16, 91, 31),      # 6 KB a relation
    ("statrmw", torch.float32, 128, 32, 30, 6),    # 32 KB a relation
    ("base", torch.float32, 16, 8, 91, 91),        # one pass
])
def test_pass_split(variant, dtype, d_in, d_out, slots, expected):
    """The relations per pass that ``statrmw``'s math depends on: at most
    227 KB of shared memory, passes as even as the slots allow."""
    got = bk.pass_rels(variant, dtype, d_in, d_out, slots)
    assert got == expected
    per_rel = d_in * d_out * ((0 if variant == "nodx" else
                               torch.finfo(dtype).bits // 8)
                              + (0 if variant == "nodw" else 4))
    assert got * per_rel <= bk.MAX_SMEM


def test_plans_of_the_rows():
    """``fold_dst`` keeps every edge with ``dst % window``; ``reverse_plan``
    swaps the forward and backward layouts, with the forward positions of
    the swapped CSR in the relation order (the tensor-core forward's
    dataflow over it gives the forward's result)."""
    rng = np.random.default_rng(3)
    src, dst, rel, norm = _graph(rng, 120, 900, 5)
    plan = sk.plan_span(src, dst, rel, norm, 120, 5)
    edges = lambda p: sorted(zip(*(a.tolist() for a in bk.plan_edge_arrays(p))))
    assert edges(plan) == sorted(zip(src.tolist(), dst.tolist(), rel.tolist(),
                                     norm.tolist()))
    folded = bk.fold_dst(plan, 16)
    assert edges(folded) == sorted(zip(src.tolist(), (dst % 16).tolist(),
                                       rel.tolist(), norm.tolist()))
    rev = bk.reverse_plan(plan)
    assert torch.equal(rev.fwd_rowptr, plan.bwd_rowptr)
    assert torch.equal(rev.bwd_dst, plan.fwd_src)
    assert (rev.num_nodes, rev.num_src) == (plan.num_src, plan.num_nodes)
    for p in (plan, folded, rev):
        assert np.array_equal(np.sort(p.fwd_pos.numpy()), np.arange(900))
        x = torch.randn(p.num_src, 6, dtype=torch.float64)
        w = torch.randn(5, 6, 3, dtype=torch.float64)
        torch.testing.assert_close(sk.span_forward_tiled_plain(x, w, p),
                                   sk.span_forward_plain(x, w, p))


def test_cpu_calls_launch_nothing_and_bad_calls_raise():
    rng = np.random.default_rng(7)
    plan = sk.plan_span(*_graph(rng, 30, 100, 4), 30, 4)
    buckets = bk.plan_buckets(plan, 8)
    x, w, g = torch.randn(30, 5), torch.randn(4, 5, 3), torch.randn(30, 3)
    before = dict(bk.LAUNCHES)
    for v in bk.VARIANTS:
        bk.span_backward_variant(g, x, w, buckets, v)
    for v in bk.SIMT_VARIANTS:
        bk.span_backward_variant_simt(g, x, w, plan, v)
    assert bk.LAUNCHES == before
    with pytest.raises(ValueError):
        bk.span_backward_variant(g, x, w, buckets, "statrmw")
    with pytest.raises(ValueError):
        bk.span_backward_variant_simt(g, x, w, plan, "tf32")
    with pytest.raises(ValueError):
        bk.span_backward_variant(g.to("meta"), x.to("meta"), w.to("meta"),
                                 buckets)
    with pytest.raises(ValueError):
        bk.span_backward_variant_simt(g.to("meta"), x.to("meta"),
                                      w.to("meta"), plan)
    with pytest.raises(ValueError):
        bk.span_backward_variant(g[:, :2], x, w, buckets)
    with pytest.raises(ValueError):
        bk.plan_buckets(plan, 2**15 + 1)


def test_entry_point_prints_every_row_on_cpu(capsys):
    """``python -m ...bwd_variants --device cpu`` at a tiny shape: every
    row is checked against its plain version and printed, with its bound;
    times are not measured; the last line is JSON."""
    res = bwd_variants.main(["--device", "cpu", "--nodes", "300", "--edges",
                             "2000", "--slots", "7", "--d-in", "16",
                             "--d-out", "8", "--inner", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(res))
    assert list(res["rows"]) == list(bwd_variants.ROWS)
    for name in bwd_variants.ROWS:
        (line,) = [ln for ln in lines if ln.split()[0] == name]
        assert "not measured" in line and "bound" in line
        row = res["rows"][name]
        assert row["ms"] is None and row["bound_ms"] >= 0
        assert (row["max_abs_err"] is None) == (name == "floor")
    only = bwd_variants.main(["--device", "cpu", "--nodes", "50", "--edges",
                              "200", "--slots", "3", "--only", "nodx,shipped",
                              "--dtype", "bfloat16"])
    assert list(only["rows"]) == ["nodx", "shipped"]
    with pytest.raises(SystemExit):
        bwd_variants.main(["--device", "cpu", "--only", "wide"])
