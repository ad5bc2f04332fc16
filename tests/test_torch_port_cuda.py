"""The CUDA kernels (span forward and backward on the tensor cores and
their earlier routes, segment sum, grouped matmul, d_rhs, halo exchange,
fused halo aggregate and the one-pass backward's variants) against their
plain PyTorch versions, on the card; and training across processes
(``multihost_sim``: the halo partition, #6 and #7 reading the other
process's rows through CUDA IPC, 2 processes sharing the card, and over
NCCL on 2 cards; the edge partition, #3, #4 and #5 on every process's
shards, 2 processes sharing the card).

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
    segment_rowptr, sorted_segment_sum, sorted_segment_sum_plain,
    sorted_segment_sum_rows)
from scaling_rgcn_training_tpu_torch.parallel.mesh import shard_rows


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
@pytest.mark.parametrize("d_in,d_out,slots", [(63, 4, 9), (63, 11, 9),
                                              (11, 63, 9), (128, 32, 30)])
@pytest.mark.parametrize("num_src", [None, 650])
def test_cuda_span_forward_tensor_cores(d_in, d_out, slots, num_src, dtype,
                                        monkeypatch):
    """#1 on the tensor cores (``csrc/span_fwd_tc.cu``) against
    ``span_forward_plain`` and ``span_forward_tiled_plain``, with empty
    relations, rows without edges, chunks of 100 edges (a chunk's end
    inside a 64-edge tile) and (``num_src``) a rectangular plan: two runs
    give the same bits, each call counts one launch and none of the row
    route; ``span_forward_rows`` still matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(d_in * d_out + slots)
    n, e = 500, 4000
    src, dst, rel, norm = _graph(rng, n, e, slots)
    if num_src is not None:
        src = rng.integers(0, num_src, e).astype(np.int32)
    monkeypatch.setattr(sk, "DW_CHUNK", 100)
    plan = sk.plan_span(src, dst, rel, norm, n, slots, device="cuda",
                        num_src=num_src)
    dt = getattr(torch, dtype)
    x = torch.randn(plan.num_src, d_in, device="cuda").to(dt)
    w = (torch.randn(slots, d_in, d_out, device="cuda") * 0.2).to(dt)
    before = dict(cuda_build.LAUNCHES)
    got, again = sk.span_forward(x, w, plan), sk.span_forward(x, w, plan)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["span_forward"] == before["span_forward"] + 2
    assert cuda_build.LAUNCHES["span_forward_rows"] == before["span_forward_rows"]
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert not got[n - n // 10:].any()          # rows without edges
    for ref in (sk.span_forward_plain(x, w, plan),
                sk.span_forward_tiled_plain(x, w, plan)):
        torch.testing.assert_close(got, ref, **_tol(dtype, ref))
    rows = sk.span_forward_rows(x, w, plan)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["span_forward_rows"] == before["span_forward_rows"] + 1
    ref = sk.span_forward_plain(x, w, plan)
    torch.testing.assert_close(rows, ref, **_tol(dtype, ref))


@pytest.mark.cuda
def test_cuda_span_forward_without_edges():
    """A plan with no edges: no chunk to multiply, every row written 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    none = np.zeros(0, np.int32)
    plan = sk.plan_span(none, none, none, none.astype(np.float32), 40, 3,
                        device="cuda")
    out = sk.span_forward(torch.randn(40, 8, device="cuda"),
                          torch.randn(3, 8, 5, device="cuda"), plan)
    torch.cuda.synchronize()
    assert out.shape == (40, 5) and not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiny", ["row", "column"])
def test_cuda_span_forward_tiny_values(tiny, dtype):
    """A row of x (a column of W) scaled by 1e-37, below the least top of
    #1's fixed-point grids: finite values that match the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(37)
    n, e, slots = 500, 4000, 9
    src, dst, rel, norm = _graph(rng, n, e, slots)
    plan = sk.plan_span(src, dst, rel, norm, n, slots, device="cuda")
    dt = getattr(torch, dtype)
    x = torch.randn(n, 64, device="cuda")
    w = torch.randn(slots, 64, 16, device="cuda") * 0.2
    if tiny == "row":
        x[int(src[0])] *= 1e-37
    else:
        w[:, :, 5] *= 1e-37
    x, w = x.to(dt), w.to(dt)
    got = sk.span_forward(x, w, plan)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    ref = sk.span_forward_plain(x, w, plan)
    torch.testing.assert_close(got, ref, **_tol(dtype, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out,slots", [(63, 4, 9), (63, 11, 9),
                                              (11, 63, 9), (64, 16, 9),
                                              (16, 8, 9), (128, 32, 30)])
@pytest.mark.parametrize("num_src", [None, 650])
def test_cuda_span_backward_tensor_cores(d_in, d_out, slots, num_src, dtype,
                                         monkeypatch):
    """#2 on the tensor cores (``csrc/span_bwd_tc.cu``) against
    ``span_backward_plain`` and ``span_backward_tiled_plain``, with empty
    relations, rows without edges, chunks of 100 edges (a chunk's end
    inside a 16-edge tile and a 4-tile stage) and (``num_src``) a
    rectangular plan: two runs give the same bits, each call counts one
    launch and none of the row route; each half alone gives the same bits;
    ``span_backward_rows`` still matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(d_in * d_out + slots + 1)
    n, e = 500, 4000
    src, dst, rel, norm = _graph(rng, n, e, slots)
    if num_src is not None:
        src = rng.integers(0, num_src, e).astype(np.int32)
    monkeypatch.setattr(sk, "DW_CHUNK", 100)
    plan = sk.plan_span(src, dst, rel, norm, n, slots, device="cuda",
                        num_src=num_src)
    dt = getattr(torch, dtype)
    x = torch.randn(plan.num_src, d_in, device="cuda").to(dt)
    w = (torch.randn(slots, d_in, d_out, device="cuda") * 0.2).to(dt)
    g = torch.randn(n, d_out, device="cuda").to(dt)
    before = dict(cuda_build.LAUNCHES)
    got, again = sk.span_backward(g, x, w, plan), sk.span_backward(g, x, w, plan)
    halves = [sk.span_backward_half(g, x, w, plan, h) for h in ("dx", "dw")]
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["span_backward"] == before["span_backward"] + 2
    assert cuda_build.LAUNCHES["span_backward_rows"] == before["span_backward_rows"]
    for a, b, h in zip(got, again, halves):
        assert a.dtype == torch.float32 and torch.equal(a, b) and torch.equal(a, h)
    assert not got[1][1::3].any()               # relations without edges
    if num_src is None:
        assert not got[0][n - n // 10:].any()   # rows without edges
    for ref in (sk.span_backward_plain(g, x, w, plan),
                sk.span_backward_tiled_plain(g, x, w, plan)):
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, **_tol(dtype, b))
    rows = sk.span_backward_rows(g, x, w, plan)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["span_backward_rows"] == before["span_backward_rows"] + 1
    for a, b in zip(rows, sk.span_backward_plain(g, x, w, plan)):
        torch.testing.assert_close(a, b, **_tol(dtype, b))


@pytest.mark.cuda
def test_cuda_span_backward_without_edges():
    """A plan with no edges: no chunk to multiply, dx and dW written 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    none = np.zeros(0, np.int32)
    plan = sk.plan_span(none, none, none, none.astype(np.float32), 40, 3,
                        device="cuda")
    dx, dw = sk.span_backward(torch.randn(40, 5, device="cuda"),
                              torch.randn(40, 8, device="cuda"),
                              torch.randn(3, 8, 5, device="cuda"), plan)
    torch.cuda.synchronize()
    assert dx.shape == (40, 8) and not dx.any()
    assert dw.shape == (3, 8, 5) and not dw.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiny", ["x row", "g row"])
def test_cuda_span_backward_tiny_values(tiny, dtype):
    """A row of x (of g) scaled by 1e-37, below the least top of #2's
    fixed-point grids: finite dx and dW that match the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(38)
    n, e, slots = 500, 4000, 9
    src, dst, rel, norm = _graph(rng, n, e, slots)
    plan = sk.plan_span(src, dst, rel, norm, n, slots, device="cuda")
    dt = getattr(torch, dtype)
    x = torch.randn(n, 64, device="cuda")
    g = torch.randn(n, 16, device="cuda")
    w = torch.randn(slots, 64, 16, device="cuda") * 0.2
    if tiny == "x row":
        x[int(src[0])] *= 1e-37
    else:
        g[int(dst[0])] *= 1e-37
    x, g, w = x.to(dt), g.to(dt), w.to(dt)
    got = sk.span_backward(g, x, w, plan)
    torch.cuda.synchronize()
    for a, b in zip(got, sk.span_backward_plain(g, x, w, plan)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **_tol(dtype, b))


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
    assert torch.equal(got, sorted_segment_sum_rows(vals, rowptr))


@pytest.mark.cuda
@pytest.mark.parametrize("gather", ["perm", "scale", "perm+scale", "offset"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [4, 8, 11, 16, 32, 64, 130])
def test_cuda_segment_sum_gather_matches_rows(h, dtype, gather):
    """The gather through ``perm`` and the ``scale`` inside the kernel:
    within tolerance of the plain version, and the bits of the earlier
    route (the multiply and ``index_select`` as passes, then
    ``segment_sum_rows_kernel``) and of a second run. ``offset``: perm and
    scale with the values one element past an aligned address, so the
    kernel takes a narrower load width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(h + len(gather))
    keys = np.sort(np.concatenate([rng.integers(0, 600, 3000) * 2,
                                   np.full(700, 901)])).astype(np.int32)
    e = len(keys)
    rowptr = torch.tensor(segment_rowptr(keys, 1300)).cuda()
    vals = torch.randn(e * h + 1, device="cuda").to(getattr(torch, dtype))
    vals = (vals[1:] if gather == "offset" else vals[:-1]).view(e, h)
    perm = torch.tensor(rng.permutation(e).astype(np.int32)).cuda()
    scale = torch.tensor(rng.random(e).astype(np.float32) + 0.1).cuda()
    kw = {"perm": None if gather == "scale" else perm,
          "scale": None if gather == "perm" else scale}
    before = dict(cuda_build.LAUNCHES)
    got = sorted_segment_sum(vals, rowptr, **kw)
    again = sorted_segment_sum(vals, rowptr, **kw)
    rows = sorted_segment_sum_rows(vals, rowptr, **kw)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["segment_sum"] == before["segment_sum"] + 2
    assert cuda_build.LAUNCHES["segment_sum_rows"] == \
        before["segment_sum_rows"] + 1
    assert torch.equal(got, again) and torch.equal(got, rows)
    ref = sorted_segment_sum_plain(vals, rowptr, **kw)
    torch.testing.assert_close(got, ref, **_tol(dtype, ref))
    empty = torch.tensor(np.setdiff1d(np.arange(1300), keys)).cuda()
    assert not got[empty].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(63, 4), (16, 8), (8, 16), (63, 11),
                                 (24, 32), (64, 16), (16, 64), (256, 64),
                                 (8, 130), (300, 11)])
def test_cuda_grouped_kernels_match_plain(k, n, dtype):
    """gmm and gmm_drhs (tensor cores) with empty groups at the start, the
    middle and the end, groups spanning 16-row, 256-row and 1024-row tiles
    and row counts that are not multiples of a tile, at every width class
    of the kernels (column tiles past 64, depth chunks past
    ``GMM_DEPTH``), against the plain versions, the tiled-plain dataflows
    and the earlier routes (``gmm_simt``, ``gmm_drhs_simt``); two runs give
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sizes = torch.tensor([0, 1500, 3, 0, 2049, 1, 0, 777, 0], device="cuda")
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
    for name in ("grouped_matmul_simt", "grouped_drhs_simt"):
        assert cuda_build.LAUNCHES[name] == before[name]
    assert torch.equal(out, out2) and torch.equal(drhs, drhs2)
    assert out.dtype == dt and drhs.dtype == torch.float32
    simt = gk.gmm_simt(lhs, rhs, sizes), gk.gmm_drhs_simt(lhs, gout, sizes)
    assert cuda_build.LAUNCHES["grouped_matmul_simt"] == \
        before["grouped_matmul_simt"] + 1
    assert cuda_build.LAUNCHES["grouped_drhs_simt"] == \
        before["grouped_drhs_simt"] + 1
    for got, refs in (
            (out, (gk.gmm_plain(lhs, rhs, sizes),
                   gk.gmm_tiled_plain(lhs, rhs, sizes), simt[0])),
            (drhs, (gk.gmm_drhs_plain(lhs, gout, sizes),
                    gk.gmm_drhs_tiled_plain(lhs, gout, sizes), simt[1]))):
        for ref in refs:
            ref = ref.float()
            torch.testing.assert_close(got.float(), ref, **_tol(dtype, ref))
    assert not drhs[sizes.cpu() == 0].any()


@pytest.mark.cuda
def test_cuda_grouped_kernels_rows_past_the_groups():
    """Rows past the last group (group sizes that sum to less than M) come
    out 0 from gmm and take no part in gmm_drhs, on both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sizes = torch.tensor([300, 0, 41], device="cuda")
    lhs = torch.randn(700, 24, device="cuda")
    rhs = torch.randn(3, 24, 16, device="cuda")
    gout = torch.randn(700, 16, device="cuda")
    for mm, drhs in ((gk.gmm, gk.gmm_drhs), (gk.gmm_simt, gk.gmm_drhs_simt)):
        out = mm(lhs, rhs, sizes)
        assert not out[341:].any()
        ref = gk.gmm_plain(lhs[:341], rhs, sizes)
        torch.testing.assert_close(out[:341], ref, **_tol("float32", ref))
        ref = gk.gmm_drhs_plain(lhs[:341], gout[:341], sizes)
        got = drhs(lhs, gout, sizes)
        torch.testing.assert_close(got, ref, **_tol("float32", ref))


@pytest.mark.cuda
def test_cuda_grouped_f32_signed_error():
    """The float32 routes' signed error against float64, relative to the
    sum of |ref|, at one relation-sized group mix (64 -> 16 over 91 groups
    of ~2,200 rows): within 1e-8 for both tensor-core kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)
    sizes = torch.randint(1500, 3000, (91,), generator=gen, device="cuda")
    m = int(sizes.sum())
    lhs = torch.randn(m, 64, generator=gen, device="cuda")
    rhs = torch.randn(91, 64, 16, generator=gen, device="cuda") * 0.2
    gout = torch.randn(m, 16, generator=gen, device="cuda")

    def signed(got, ref):
        return float(((got.double() - ref) * ref.sign()).sum()
                     / ref.abs().sum())

    assert abs(signed(gk.gmm(lhs, rhs, sizes),
                      gk.gmm_plain(lhs.double(), rhs.double(), sizes))) < 1e-8
    assert abs(signed(gk.gmm_drhs(lhs, gout, sizes),
                      gk.gmm_drhs_plain(lhs.double(), gout.double(),
                                        sizes))) < 1e-8


@pytest.mark.cuda
def test_cuda_edge_mode_fit_never_takes_the_simt_routes():
    """Trainer.fit in edge mode on the card (backend "pallas": gmm forward
    and d_lhs, gmm_drhs, the segment sums with their gathers) launches
    the redesigned kernels on every step and the earlier routes on
    none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph
    from scaling_rgcn_training_tpu_torch.models.heads import HEADS
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
        auto_mode, build_rel_edges)
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss
    from scaling_rgcn_training_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(7)
    # few edges for the nodes x relations: the traffic rule takes the edge
    # mode for both layers (a prematmul layer would launch no gmm)
    n, e, slots, emb, hl, c = 3000, 6000, 30, 16, 8, 4
    src, dst, rel, _ = _graph(rng, n, e, slots)
    labelled = rng.choice(n, 600, replace=False)
    onehot = torch.eye(c)[torch.as_tensor(np.arange(600) % c)]
    t = lambda a: torch.as_tensor(a).to("cuda")
    edges = build_rel_edges(src, dst, rel, n, slots, device="cuda", span=False)
    assert auto_mode(edges, emb, hl) == auto_mode(edges, hl, c) == "edge"
    graph = DeviceGraph(
        edges=edges, x_train=t(labelled[:400]), y_train=t(onehot[:400]),
        x_val=t(labelled[400:]), y_val=t(onehot[400:]))
    trainer = Trainer(None, hl, 4, emb, lr=0.01, weight_d=5e-5, seed=0,
                      device="cuda", backend="pallas")
    model = HEADS["summation"](trainer.gen, slots, hl, c, n, emb,
                               device="cuda")
    counts = []
    cuda_build.reset_launch_counts()
    trainer.fit(model, graph, bce_loss, "sigmoid", sum_graph=False,
                verbose=False, on_epoch=lambda _: counts.append(
                    dict(cuda_build.LAUNCHES)))
    for prev, now in zip([dict.fromkeys(counts[0], 0)] + counts, counts):
        step = {k: now[k] - prev[k] for k in now}
        assert step["grouped_matmul"] >= 4 and step["grouped_drhs"] >= 2
        assert step["segment_sum"] >= 4
        assert step["grouped_matmul_simt"] == 0
        assert step["grouped_drhs_simt"] == 0
        assert step["segment_sum_rows"] == 0


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
    assert not gk.gmm_simt(torch.ones(5, 4, device="cuda"),
                           torch.ones(2, 4, 0, device="cuda"), sizes).numel()
    assert not gk.gmm_drhs_simt(torch.ones(5, 0, device="cuda"),
                                torch.ones(5, 3, device="cuda"), sizes).numel()
    # no rows, and a product over no depth: zeros, nothing launched
    for mm in (gk.gmm, gk.gmm_simt):
        assert not mm(torch.ones(0, 4, device="cuda"),
                      torch.ones(2, 4, 3, device="cuda"),
                      torch.zeros(2, dtype=torch.int64, device="cuda")).numel()
    assert not gk.gmm(torch.ones(5, 0, device="cuda"),
                      torch.ones(2, 0, 3, device="cuda"), sizes).any()
    for seg in (sorted_segment_sum, sorted_segment_sum_rows):
        assert not seg(torch.ones(0, 4, device="cuda"),
                       torch.zeros(1, dtype=torch.int32, device="cuda")).numel()
        assert not seg(torch.ones(3, 4, device="cuda"),
                       torch.zeros(1, dtype=torch.int32, device="cuda"),
                       perm=torch.zeros(0, dtype=torch.int32, device="cuda"),
                       scale=torch.ones(3, device="cuda")).numel()
    assert cuda_build.LAUNCHES == before


# -- kernels #6 (halo_exchange) and #7 (fused_halo_aggregate) ---------------

def _halo_graph(rng, s_n, n_nodes, e, slots):
    """Random edges of an ``s_n``-shard halo partition in which shard 1
    (when there is one) has no halo edges and the last shard (from 3
    shards on) ships no rows: nobody else reads it."""
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        halo_partition_edges)

    n_per = -(-n_nodes // s_n)
    dst = rng.integers(0, n_nodes, e)
    src = rng.integers(0, n_nodes, e)
    owner = dst // n_per
    if s_n >= 2:
        m = owner == 1
        src[m] = np.minimum(n_per + rng.integers(0, n_per, int(m.sum())),
                            n_nodes - 1)
    if s_n >= 3:
        m = (src // n_per == s_n - 1) & (owner != s_n - 1)
        src[m] = rng.integers(0, n_per, int(m.sum()))
    typ = rng.integers(0, slots, e)
    return halo_partition_edges(src, dst, typ, n_nodes, slots, s_n,
                                pad_to_multiple=8, halo_multiple=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_n,h,d", [(1, 37, 11), (2, 37, 4), (3, 37, 63),
                                     (4, 64, 16), (3, 5, 1)])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_halo_exchange_matches_plain(s_n, h, d, dtype, offset):
    """Kernel #6 against its plain version: the same bits, at H and d that
    are not multiples of the vector width and (``offset``) with sends
    that do not start on a 16-byte boundary."""
    from scaling_rgcn_training_tpu_torch.parallel import ring_halo as rh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    flat = torch.randn(offset + s_n * s_n * h * d, device="cuda").to(dt)
    sends = list(flat[offset:].view(s_n, s_n, h, d).unbind(0))
    before = cuda_build.LAUNCHES["halo_exchange"]
    got = rh.halo_exchange(sends)
    again = rh.halo_exchange(sends)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["halo_exchange"] == before + 2
    for a, b, c in zip(got, again, rh.halo_exchange_plain(sends)):
        assert torch.equal(a, c) and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_n,d_in,d_out", [(1, 63, 4), (2, 4, 11),
                                            (3, 11, 63), (4, 64, 16),
                                            (2, 63, 4)])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_fused_halo_matches_plain(s_n, d_in, d_out, dtype, offset,
                                       monkeypatch):
    """Kernel #7 against its plain version, its dataflow in PyTorch and its
    earlier route for every shard (the halo buffer bit for bit), with the
    shards' rows as views of one tensor: at ``n_per * d_in`` odd (2, 63,
    4; 3, 11, 63) and from ``offset`` 1 on, bases that break the 16-byte
    (bfloat16: the 4-byte) alignment; then the halo conv's values and
    gradients with kernel #7 against the library exchange, on S virtual
    shards."""
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer
    from scaling_rgcn_training_tpu_torch.parallel import fused_halo as fh
    from scaling_rgcn_training_tpu_torch.parallel import halo as hp
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(s_n * d_in + d_out)
    slots = 7
    mesh = make_mesh(devices=("cuda",) * s_n)
    he = hp.device_put_halo_edges(_halo_graph(rng, s_n, 301, 2500, slots),
                                  mesh)
    dt = getattr(torch, dtype)
    x = torch.randn(s_n * he.n_per, d_in, device="cuda")
    flat = torch.empty(offset + x.numel(), dtype=dt, device="cuda")
    flat[offset:] = x.to(dt).flatten()
    xs = list(flat[offset:].view_as(x).split(he.n_per))
    assert bool(xs[0].data_ptr() % 16) == bool(offset)
    w = (torch.randn(slots, d_in, d_out, device="cuda") * 0.2).to(dt)
    before = dict(cuda_build.LAUNCHES)
    for sh in he.shards:
        agg, buf = fh.fused_halo_aggregate(xs, w, sh.fused)
        agg2, buf2 = fh.fused_halo_aggregate(xs, w, sh.fused)
        rows, rows_buf = fh.fused_halo_aggregate_rows(xs, w, sh.fused)
        torch.cuda.synchronize()
        assert torch.equal(agg, agg2) and torch.equal(buf, buf2)
        ref, ref_buf = fh.fused_halo_aggregate_plain(xs, w, sh.fused)
        tiled, tiled_buf = fh.fused_halo_aggregate_tiled_plain(xs, w,
                                                               sh.fused)
        assert torch.equal(buf, ref_buf) and torch.equal(rows_buf, ref_buf)
        assert torch.equal(tiled_buf, ref_buf)
        torch.testing.assert_close(agg, ref, **_tol(dtype, ref))
        torch.testing.assert_close(agg, tiled, **_tol(dtype, tiled))
        torch.testing.assert_close(rows, ref, **_tol(dtype, ref))
        no_buf, none = fh.fused_halo_aggregate(xs, w, sh.fused,
                                               want_buf=False)
        torch.cuda.synchronize()
        assert none is None and torch.equal(no_buf, agg)
    for key, n in (("fused_halo_aggregate", 3),
                   ("fused_halo_aggregate_rows", 1)):
        assert cuda_build.LAUNCHES[key] == before[key] + n * s_n

    layer = RGCNLayer((torch.randn(slots, d_in, d_out, device="cuda") * 0.2),
                      torch.randn(d_in, d_out, device="cuda") * 0.2,
                      torch.randn(d_out, device="cuda"))
    g = torch.randn(s_n * he.n_per, d_out, device="cuda")
    results = []
    for mode in (None, "1", "fused"):
        if mode is None:
            monkeypatch.delenv(hp.EXCHANGE_ENV, raising=False)
        else:
            monkeypatch.setenv(hp.EXCHANGE_ENV, mode)
        layer.zero_grad()
        xg = x.clone().requires_grad_(True)
        out = hp.halo_rgcn_conv(
            shard_rows(xg, mesh), he, layer, mesh,
            compute_dtype=None if dtype == "float32" else dt).gather()
        (out * g).sum().backward()
        torch.cuda.synchronize()
        results.append([out.detach(), xg.grad, layer.weight.grad.clone()])
    for got in results[1:]:
        for a, b in zip(got, results[0]):
            torch.testing.assert_close(a, b, **_tol(dtype, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_n,d", [(2, 16), (3, 64), (4, 63)])
def test_cuda_send_transpose_matches_index_add(s_n, d, dtype):
    """The send gather's transpose (kernel #3 over each shard's CSR of
    ``send_idx``, a subset of the ``S * H`` slots, no scale) on cotangents
    that are zero in the padding slots: within the tolerance of
    ``index_add`` over ``send_idx`` in float64 and of the plain version,
    the same bits on a second run, one ``segment_sum`` launch a call.
    From 3 shards the last one ships no rows (an empty CSR)."""
    from scaling_rgcn_training_tpu_torch.parallel import halo as hp
    from scaling_rgcn_training_tpu_torch.parallel import ring_halo as rh
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(s_n * 100 + d)
    host = _halo_graph(rng, s_n, 301 * s_n - 3, 2500 * s_n, 7)
    he = hp.device_put_halo_edges(host, make_mesh(devices=("cuda",) * s_n))
    dt = getattr(torch, dtype)
    rows = s_n * he.halo
    for sh, cpu_sh in zip(he.shards, host.shards):
        used = torch.zeros(rows, dtype=torch.bool, device="cuda")
        used[sh.send_perm.long()] = True
        g = (torch.randn(rows, d, device="cuda") * used[:, None]).to(dt)
        before = cuda_build.LAUNCHES["segment_sum"]
        got, again = rh.send_transpose(g, sh), rh.send_transpose(g, sh)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["segment_sum"] == before + 2
        assert got.dtype == torch.float32 and got.shape == (he.n_per, d)
        assert torch.equal(got, again)
        want = torch.zeros(he.n_per, d, dtype=torch.float64,
                           device="cuda").index_add_(0, sh.send_idx, g.double())
        torch.testing.assert_close(got.double(), want, **_tol(dtype, want))
        plain = rh.send_transpose(g.cpu(), cpu_sh)
        torch.testing.assert_close(got.cpu(), plain, **_tol(dtype, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out", [(63, 4), (11, 63), (16, 8), (64, 16),
                                        (128, 32)])
@pytest.mark.parametrize("variant", ["base", "nodw", "nodx", "statrmw"])
def test_cuda_bwd_variant_matches_plain(variant, d_in, d_out, dtype):
    """Kernel #8's earlier route (``span_backward_variant_simt``) against
    its plain versions, with empty relations, rows without edges and
    (128 -> 32, 30 slots) several relation passes; on a plan with ``dst``
    folded into a window too."""
    from scaling_rgcn_training_tpu_torch.ops import bwd_kernels as bk

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(d_in + 7 * d_out)
    n, e, slots = 500, 4000, 30
    src, dst, rel, norm = _graph(rng, n, e, slots)
    plan = sk.plan_span(src, dst, rel, norm, n, slots, device="cuda")
    dt = getattr(torch, dtype)
    x = torch.randn(n, d_in, device="cuda").to(dt)
    w = (torch.randn(slots, d_in, d_out, device="cuda") * 0.2).to(dt)
    g = torch.randn(n, d_out, device="cuda").to(dt)
    for p in (plan, bk.fold_dst(plan, 37)):
        before = cuda_build.LAUNCHES["span_backward_variant_simt"]
        got = bk.span_backward_variant_simt(g, x, w, p, variant)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["span_backward_variant_simt"] == before + 1
        ref = bk.span_backward_variant_simt_plain(g, x, w, p, variant)
        for a, b in zip(got, ref):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == torch.float32
                torch.testing.assert_close(a, b, **_tol(dtype, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out,bucket_rows", [
    (63, 4, 64), (11, 63, 64), (16, 8, 128), (64, 16, 64), (64, 16, 7),
    (128, 32, 32)])
@pytest.mark.parametrize("variant", ["base", "nodw", "nodx", "tf32"])
def test_cuda_bwd_tc_matches_plain(variant, d_in, d_out, bucket_rows, dtype):
    """Kernel #8's redesign (``span_backward_variant``, ``bwd_tc_kernel``)
    against its plain versions over buckets of several sizes (7 rows: more
    buckets than blocks; 128 -> 32 over 32-row buckets: several relation
    passes), with empty relations and rows without edges, on a plan with
    ``dst`` folded into a window too; two runs give the same bits of dx and
    dW, and each call moves its launch counter by one."""
    from scaling_rgcn_training_tpu_torch.ops import bwd_kernels as bk

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(d_in + 7 * d_out + bucket_rows)
    n, e, slots = 500, 4000, 30
    src, dst, rel, norm = _graph(rng, n, e, slots)
    plan = sk.plan_span(src, dst, rel, norm, n, slots, device="cuda")
    dt = getattr(torch, dtype)
    x = torch.randn(n, d_in, device="cuda").to(dt)
    w = (torch.randn(slots, d_in, d_out, device="cuda") * 0.2).to(dt)
    g = torch.randn(n, d_out, device="cuda").to(dt)
    for p in (plan, bk.fold_dst(plan, 37)):
        buckets = bk.plan_buckets(p, bucket_rows)
        before = cuda_build.LAUNCHES["span_backward_variant"]
        got = bk.span_backward_variant(g, x, w, buckets, variant)
        again = bk.span_backward_variant(g, x, w, buckets, variant)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["span_backward_variant"] == before + 2
        ref = bk.span_backward_variant_plain(g, x, w, buckets, variant)
        for a, b, c in zip(got, again, ref):
            assert (a is None) == (c is None)
            if a is not None:
                assert a.dtype == torch.float32
                assert torch.equal(a, b)
                torch.testing.assert_close(a, c, **_tol(dtype, c))


@pytest.mark.cuda
def test_cuda_halo_kernels_on_two_cards():
    """A mesh of two real cards: kernels #6 and #7 read the peer card's
    memory and match their plain versions."""
    from scaling_rgcn_training_tpu_torch.parallel import fused_halo as fh
    from scaling_rgcn_training_tpu_torch.parallel import halo as hp
    from scaling_rgcn_training_tpu_torch.parallel import ring_halo as rh
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_mesh(2)
    sends = [torch.randn(2, 37, 11, device=dev) for dev in mesh.devices]
    for a, b in zip(rh.halo_exchange(sends), rh.halo_exchange_plain(sends)):
        torch.cuda.synchronize()
        assert a.device == b.device and torch.equal(a, b)
    rng = np.random.default_rng(0)
    he = hp.device_put_halo_edges(_halo_graph(rng, 2, 301, 2500, 7), mesh)
    xs = [torch.randn(he.n_per, 16, device=dev) for dev in mesh.devices]
    for sh, dev in zip(he.shards, mesh.devices):
        w = torch.randn(7, 16, 8, device=dev) * 0.2
        agg, buf = fh.fused_halo_aggregate(xs, w, sh.fused)
        torch.cuda.synchronize()
        ref, ref_buf = fh.fused_halo_aggregate_plain(xs, w, sh.fused)
        assert torch.equal(buf, ref_buf)
        torch.testing.assert_close(agg, ref, **_tol("float32", ref))


def _overlap_run(mesh, he, x, w, gout, backend=None):
    """``halo_aggregate``'s value and ``x``, ``w`` gradients (synchronised)."""
    from scaling_rgcn_training_tpu_torch.parallel import halo as hp

    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = hp.halo_aggregate(shard_rows(xg, mesh), wg, he, mesh,
                            backend=backend).gather()
    grads = torch.autograd.grad(out, (xg, wg), gout)
    torch.cuda.synchronize()
    return (out.detach(), *grads)


def _overlap_arms(mesh, he, exchange, dtype, backend=None):
    """Both arms of the overlapped exchange on ``mesh``: whether they give
    the same bits, whether two overlapped runs repeat theirs, the
    overlapped run and its inputs ``(x, w, gout)``."""
    from scaling_rgcn_training_tpu_torch import measure_overlap as mo
    from scaling_rgcn_training_tpu_torch.parallel import halo as hp
    from scaling_rgcn_training_tpu_torch.utils import tracing

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = hp.padded_num_nodes(he)
    dt = getattr(torch, dtype)
    inputs = (torch.randn(rows, 16, generator=gen, device="cuda").to(dt),
              (torch.randn(7, 16, 8, generator=gen, device="cuda")
               * 0.3).to(dt),
              torch.randn(rows, 8, generator=gen, device="cuda"))
    inputs = tuple(t.to(mesh.first) for t in inputs)
    with mo.env_set(hp.EXCHANGE_ENV, mo.EXCHANGES[exchange]):
        with mo.env_set(hp.BLOCK_OVERLAP_ENV, "1"):
            blocked = _overlap_run(mesh, he, *inputs, backend)
        with mo.env_set(hp.BLOCK_OVERLAP_ENV, None):
            over = _overlap_run(mesh, he, *inputs, backend)
            repeats = tracing.determinism_check(
                _overlap_run, mesh, he, *inputs, backend)
    return tracing.same_bits(over, blocked), repeats, over, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exchange", ["library", "kernel"])
def test_cuda_overlap_arms_same_bits(exchange, dtype, backend):
    """``halo_aggregate`` on 4 virtual shards of the card with
    ``RGCN_HALO_BLOCK_OVERLAP`` unset (the exchange on the exchange stream
    while the owner-local segment runs) and set: the same bits of the value
    and the ``x`` and ``w`` gradients, for the library exchange and #6, span
    and edge mode; two overlapped runs repeat their bits; the overlapped
    run within the tolerance of the CPU run (plain versions)."""
    from scaling_rgcn_training_tpu_torch import measure_overlap as mo
    from scaling_rgcn_training_tpu_torch.parallel import halo as hp
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    host = _halo_graph(np.random.default_rng(11), 4, 1201, 10000, 7)
    mesh = make_mesh(devices=("cuda",) * 4)
    he = hp.device_put_halo_edges(host, mesh)
    same, repeats, over, inputs = _overlap_arms(mesh, he, exchange, dtype,
                                                backend)
    assert same and repeats
    cpu = make_mesh(devices=("cpu",) * 4)
    with mo.env_set(hp.EXCHANGE_ENV, mo.EXCHANGES[exchange]):
        ref = _overlap_run(cpu, hp.device_put_halo_edges(host, cpu),
                           *(t.cpu() for t in inputs), backend)
    for a, b in zip(over, ref):
        torch.testing.assert_close(a.float().cpu(), b.float(),
                                   **_tol(dtype, b.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["library", "kernel"])
def test_cuda_overlap_on_two_cards(exchange):
    """A mesh of two real cards (an exchange stream on each): both arms
    give the same bits of the value and gradients, float32 and bfloat16,
    and two overlapped runs repeat theirs."""
    from scaling_rgcn_training_tpu_torch.parallel import halo as hp
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_mesh(2)
    he = hp.device_put_halo_edges(
        _halo_graph(np.random.default_rng(12), 2, 901, 8000, 7), mesh)
    for dtype in ("float32", "bfloat16"):
        same, repeats, _, _ = _overlap_arms(mesh, he, exchange, dtype)
        assert same and repeats, dtype


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["library", "kernel"])
def test_cuda_measure_overlap_windows(exchange, tmp_path, monkeypatch):
    """``measure_overlap`` on 4 virtual shards of the card at a small size:
    the arms' bits equal, each traced forward and backward shows the
    exchange stream's work, and no compute kernel runs inside it in the
    blocked arm; one step of ``multihost_sim``'s loop in both arms with the
    same bits, repeating them, none inside the window when blocked."""
    from scaling_rgcn_training_tpu_torch import measure_overlap as mo
    from scaling_rgcn_training_tpu_torch import multihost_sim as mh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, value in (("OV_NODES", "20000"), ("OV_EDGES", "200000"),
                        ("OV_DEVICES", "4"), ("OV_INNER", "2")):
        monkeypatch.setenv(name, value)
    s = mo.setup(mo.knobs(), "cuda")
    rec = mo.measure(s, exchange, str(tmp_path))
    assert rec["same_bits"]
    for arm in ("overlapped", "blocked"):
        for way in ("forward", "backward"):
            win = rec["arms"][arm]["window"][way]
            assert win["window_ms"] > 0
            if arm == "blocked":
                assert win["inside"] == 0, (way, win)
    params = mh.make_params(s["x"].num_rows, (64, 16, 8), s["slots"])
    rows, y = mh.labels(s["nodes"], 8, 512)
    step = mo.make_step(s["mesh"], s["plan"], params, rows, y)
    res = mo.compare_step(step, s["mesh"].devices, exchange, steps=2,
                          trace_dir=str(tmp_path))
    assert res["same_bits"] and res["repeats_bits"]
    assert res["window"]["blocked"]["inside"] == 0


def _multihost(tmp_path, tag, *extra):
    """``multihost_sim`` on the card at N 4096, E 32768, 3 float32 steps;
    its record (the run raises, and exits non-zero, when a child fails, a
    child misses a kernel on a step or the losses differ)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, MH_NODES="4096",
               MH_EDGES="32768", MH_STEPS="3", MH_BF16="0")
    env.pop("MH_PORT", None)
    res = subprocess.run(
        [sys.executable, "-m", "scaling_rgcn_training_tpu_torch.multihost_sim",
         "--device", "cuda", "--procs", "2", "--workdir",
         str(tmp_path / tag), "--timeout", "240", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_cuda_two_processes_on_one_card(tmp_path):
    """2 processes x 2 shards sharing the card (gloo): kernels #6 and #7
    read the other process's rows through CUDA IPC and match their plain
    versions (``--check``), every mode's losses match the single-process
    run's, and two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = ("--shards-per-proc", "2", "--cards", "1", "--modes",
            "library,kernel,fused,fused-bf16")
    first = _multihost(tmp_path, "a", *args, "--check")
    again = _multihost(tmp_path, "b", *args)
    assert first["backend"] == "gloo" and first["loss_parity"] is True
    assert [c["shards"] for c in first["check"][0]] == [2, 4]
    for tag, m in first["modes"].items():
        assert m["multi_process_losses"] == \
            again["modes"][tag]["multi_process_losses"], tag
        kernel = {"library": "span_forward", "kernel": "halo_exchange",
                  "fused": "fused_halo_aggregate"}[tag.split("-")[0]]
        assert all(st[kernel] > 0 for proc in m["launches"] for st in proc)


@pytest.mark.cuda
def test_cuda_two_processes_edge_partition_on_one_card(tmp_path):
    """2 processes x 2 shards sharing the card (gloo) in the edge
    partition, float32 and bfloat16 streams: every child launches #4 and
    #3 4 k times and #5 2 k times on every step and no span or halo
    kernel, one layer's sums across processes have one process's bits
    (``--check``), the losses have the single-process run's bits and both
    processes end with the same bits of every replicated tensor and Adam
    moment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rec = _multihost(tmp_path, "edge", "--shards-per-proc", "2", "--cards",
                     "1", "--modes", "edge-f32,edge-bf16", "--check")
    assert rec["backend"] == "gloo" and rec["loss_parity"] is True
    assert rec["replicated_bits_equal"] is True
    assert [c["shards"] for c in rec["edge_check"][0]] == [2, 2, 4, 4]
    want = {"grouped_matmul": 8, "segment_sum": 8, "grouped_drhs": 4}
    for tag, m in rec["modes"].items():
        assert m["first_loss_same_bits"] is True, tag
        assert m["loss_series_same_bits"] is True, tag
        for proc in m["launches"]:
            assert len(proc) == 3
            assert all({n: c for n, c in st.items() if c} == want
                       for st in proc), (tag, proc)


@pytest.mark.cuda
def test_cuda_two_processes_on_two_cards(tmp_path):
    """2 processes x 1 card over NCCL: #6 and #7 read the peer card's
    rows through CUDA IPC; the losses match the single-process run's."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rec = _multihost(tmp_path, "nccl", "--shards-per-proc", "1", "--cards",
                     "2", "--modes", "library,kernel,fused", "--check")
    assert rec["backend"] == "nccl" and rec["loss_parity"] is True


@pytest.mark.cuda
def test_cuda_rehearse_am_fused_matches_edge_mode():
    """``rehearse_am``'s loop at a mid size (N 200,000, E 1,500,000, 133
    relations -> 267 slots, 64 -> 16 -> 11), float32: the fused run (#1,
    #2 on every step, no #3-#5) against edge mode (#3, #4, #5, no #1, #2),
    losses within 1e-4 relative at every step (chip_smoke.py phase 5's and
    13's criterion)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch import rehearse_am as ra

    k = {"nodes": 200_000, "edges": 1_500_000, "rels": 133, "dim": 64,
         "hidden": 16, "inner": 3, "calls": 1, "plan_cache": None}
    dev = torch.device("cuda")
    edges, rows, targets, slots, _ = ra.build_edges(k, dev)
    runs = {mode: ra.run(k, dev, edges, rows, targets, slots, None, mode)
            for mode in ("fused", "edge")}
    np.testing.assert_allclose(runs["edge"]["losses"],
                               runs["fused"]["losses"], rtol=1e-4, atol=0)
    for st in runs["fused"]["launches"]:
        assert st["span_forward"] == 2 and st["span_backward"] == 2
        assert not (st["grouped_matmul"] or st["segment_sum"]
                    or st["grouped_drhs"])
    for st in runs["edge"]["launches"]:
        assert st["grouped_matmul"] >= 4 and st["segment_sum"] >= 4
        assert st["grouped_drhs"] == 2
        assert not (st["span_forward"] or st["span_backward"])


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["1", "fused"])
def test_cuda_rehearse_am_dist_step_matches_unpartitioned(exchange,
                                                          monkeypatch):
    """``rehearse_am_dist``'s executed step over 8 virtual shards of the
    card at a mid size (N 200,000, E 1,500,000, 267 slots), float32, with
    #6 (``=1``) and #7 (``=fused``): every step launches the mode's
    kernels, and the losses match the same loop unpartitioned through the
    fused conv within 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch import rehearse_am_dist as rd
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        EXCHANGE_ENV, device_put_halo_edges, padded_num_nodes)
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

    k = {"nodes": 200_000, "edges": 1_500_000, "rels": 133, "dim": 64,
         "hidden": 16}
    rng = np.random.default_rng(0)
    typ = rd.relations(rng, k)
    src, dst = rd.gen(rng, "uniform", k["nodes"], k["edges"])
    slots = 2 * k["rels"] + 1
    dev = torch.device("cuda")
    mesh = make_mesh(devices=("cuda",) * rd.S)
    he = device_put_halo_edges(rd.partition(src, dst, typ, k["nodes"],
                                            slots), mesh)
    params = rd.make_params(padded_num_nodes(he), k, slots)
    ref = rd.run_loop(params, rd.unpartitioned_conv(
        src, dst, typ, padded_num_nodes(he), slots, dev, None), dev, 4)
    monkeypatch.setenv(EXCHANGE_ENV, exchange)
    res = rd.run_loop(params, rd.halo_conv(he, mesh, None), dev, 4, mesh)
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-4,
                               atol=0)
    kernel = "halo_exchange" if exchange == "1" else "fused_halo_aggregate"
    want = 4 if exchange == "1" else 2 * rd.S
    assert all(st[kernel] == want and st["span_backward"] == 4 * rd.S
               for st in res["launches"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bench_launches_the_span_kernels(dtype, monkeypatch):
    """``bench`` at a small shape (N 20,000, E 200,000, 10 relations) on
    the card: #1 and #2 twice a timed step, no other kernel, a finite
    line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch import bench

    for name, value in (("BENCH_NODES", "20000"), ("BENCH_EDGES", "200000"),
                        ("BENCH_RELS", "10"), ("BENCH_INNER", "3"),
                        ("BENCH_STEPS", "3"), ("BENCH_DEVICE", "cuda"),
                        ("BENCH_COMPUTE_DTYPE", dtype)):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("BENCH_SKIP_BASELINE", raising=False)
    rec = bench.main()
    lps = rec["launches_per_step"]
    assert {n: c for n, c in lps.items() if c} == {"span_forward": 2,
                                                   "span_backward": 2}
    assert rec["compute_dtype"] == dtype and rec["peak_mib"] > 0
    assert all(np.isfinite(rec[k]) for k in (
        "value", "vs_baseline", "ms_per_step", "baseline_ms_per_step",
        "achieved_gbps_est"))


def _route_fit(route, config, epochs=10, ckpt=None):
    """One ``Trainer.fit`` of ``config`` on the card in ``route``
    (``"graph"`` or ``"eager"``, ``RGCN_EAGER_STEP``), from seed 0:
    ``(losses, validation series, parameters, Adam's state)`` on the
    host. ``config``: ``fused``, ``fused-bf16``, ``edge``, ``attention``
    (the attention head, its dropout on) or ``halo-library``, ``halo-#6``,
    ``halo-#7`` (4 virtual shards). ``ckpt``: ``(path, every, stop)``, a
    checkpointing fit that raises after epoch ``stop`` (None: runs
    through)."""
    from scaling_rgcn_training_tpu_torch import measure_overlap as mo
    from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph
    from scaling_rgcn_training_tpu_torch.models.heads import HEADS
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
    from scaling_rgcn_training_tpu_torch.parallel import halo as hp
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh
    from scaling_rgcn_training_tpu_torch.train import step_graph
    from scaling_rgcn_training_tpu_torch.train import trainer as trainer_mod
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss
    from scaling_rgcn_training_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(17)
    n, e, slots, emb, hl, c = 3000, 24000, 9, 16, 8, 4
    src, dst, rel, _ = _graph(rng, n, e, slots)
    labelled = rng.choice(n - n // 10, 600, replace=False)
    onehot = torch.eye(c)[torch.as_tensor(np.arange(600) % c)]
    t = lambda a: torch.as_tensor(a).to("cuda")
    splits = dict(x_train=t(labelled[:400]), y_train=t(onehot[:400]),
                  x_val=t(labelled[400:]), y_val=t(onehot[400:]))
    kw, head, exchange = {}, "summation", None
    if config.startswith("halo"):
        exchange = {"library": None, "#6": "1", "#7": "fused"}[
            config.split("-")[1]]
        mesh = make_mesh(devices=("cuda",) * 4)
        edges = hp.device_put_halo_edges(hp.halo_partition_edges(
            src, dst, rel, n, slots, 4), mesh)
        kw = dict(mesh=mesh, partition="halo")
    else:
        edges = build_rel_edges(src, dst, rel, n, slots, device="cuda",
                                span=config != "edge")
        kw = dict(backend="pallas") if config == "edge" else {}
        head = "attention" if config == "attention" else head
    trainer = Trainer(None, hl, epochs, emb, lr=0.01, weight_d=5e-5, seed=0,
                      device="cuda", compute_dtype="bfloat16"
                      if config == "fused-bf16" else None, **kw)
    model = HEADS[head](trainer.gen, slots, hl, c, n, emb, num_sums=2,
                        device="cuda")
    if head == "attention":
        model.embedding = torch.nn.Parameter(
            torch.rand((2, n, emb), generator=trainer.gen).to("cuda"))
    fit_kw, opts = {}, []
    if ckpt is not None:
        path, trainer.ckpt_every, stop = ckpt

        def on_epoch(epoch):
            if epoch + 1 == stop:
                raise _Stop

        fit_kw = dict(ckpt_path=path, on_epoch=on_epoch if stop else None)
    made = trainer_mod.make_optimizer
    trainer_mod.make_optimizer = lambda *a, **k: opts.append(
        made(*a, **k)) or opts[-1]
    try:
        with mo.env_set(step_graph.EAGER_ENV,
                        "1" if route == "eager" else None), \
                mo.env_set(hp.EXCHANGE_ENV, exchange):
            assert trainer.step_route() == route
            _, accs, losses, f1w, f1m = trainer.fit(
                model, DeviceGraph(edges=edges, **splits), bce_loss,
                "sigmoid", sum_graph=False, frozen=("embedding",)
                if head == "attention" else (), verbose=False, **fit_kw)
    finally:
        trainer_mod.make_optimizer = made
    torch.cuda.synchronize()
    state = opts[0].state.values()
    return (losses, (accs, f1w, f1m),
            [p.detach().cpu() for p in model.parameters()],
            [{k: v.detach().cpu() for k, v in s.items()} for s in state],
            {str(s["step"].device) for s in state})


class _Stop(Exception):
    """Raised by ``on_epoch`` to stop a checkpointing fit."""


def _same(a, b):
    from scaling_rgcn_training_tpu_torch.utils import tracing

    return tracing.same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fused", "fused-bf16", "edge",
                                    "attention", "halo-library", "halo-#6",
                                    "halo-#7"])
def test_cuda_step_graph_same_bits_as_eager(config):
    """``Trainer.fit``'s step captured as a CUDA graph and replayed
    against the same step run eagerly (``RGCN_EAGER_STEP=1``), 10 epochs
    from one seed: the losses, the validation series, every parameter and
    Adam's moments with the same bits; Adam's step on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eager = _route_fit("eager", config)
    graph = _route_fit("graph", config)
    assert all(np.isfinite(graph[0]))
    for got, ref in zip(graph[:4], eager[:4]):
        assert _same(ref, got)
    assert graph[4] == eager[4] == {"cuda:0"}


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fused", "halo-#7"])
def test_cuda_step_graph_resume(config, tmp_path):
    """A graphed fit that checkpoints every 4 epochs, stopped after 4 and
    resumed (the warm-up and the capture after the restore): the
    unbroken eager run's bits, Adam's step on the card after the
    restore."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = str(tmp_path / "fit.npz")
    unbroken = _route_fit("eager", config)
    with pytest.raises(_Stop):
        _route_fit("graph", config, ckpt=(path, 4, 4))
    resumed = _route_fit("graph", config, ckpt=(path, 4, None))
    for got, ref in zip(resumed[:4], unbroken[:4]):
        assert _same(ref, got)
    assert resumed[4] == {"cuda:0"}


@pytest.mark.cuda
def test_cuda_step_graph_counts_replayed_launches():
    """``rehearse_am.train`` on the card at a small shape: the route is
    the graph, every step (warm-up and replays) counts #1 and #2 twice,
    and a step that reads a value back raises in the last warm-up step,
    before any capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch import rehearse_am as ra
    from scaling_rgcn_training_tpu_torch.train.step_graph import (
        WARMUP, CudaStepGraph, StepGraph)

    k = {"nodes": 5000, "edges": 40000, "rels": 5, "dim": 16, "hidden": 8,
         "inner": 3, "calls": 2, "plan_cache": None}
    dev = torch.device("cuda")
    edges, rows, targets, slots, _ = ra.build_edges(k, dev)
    res = ra.run(k, dev, edges, rows, targets, slots)
    assert res["step"] == "graph" and len(res["losses"]) == 9
    assert all(st["span_forward"] == 2 and st["span_backward"] == 2
               for st in res["launches"])
    x = torch.ones(4, device="cuda")
    with StepGraph(lambda: (x.sum() * float(x.sum()),), 3, 1, dev,
                   CudaStepGraph(dev)) as loop:
        for _ in range(WARMUP - 1):
            loop.run()
        with pytest.raises(RuntimeError):
            loop.run()


@pytest.mark.cuda
def test_cuda_make_optimizer_is_capturable():
    """Adam on the card is ``capturable`` (its step count on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer

    p = torch.nn.Parameter(torch.zeros(3, device="cuda"))
    opt = make_optimizer([p], 0.01)
    p.grad = torch.ones_like(p)
    opt.step()
    assert opt.defaults["capturable"] is True
    assert opt.state[p]["step"].device == p.device


@pytest.mark.cuda
def test_cuda_step_graph_stream_is_never_the_exchange_stream():
    """The step graph's side stream comes from another pool than the halo
    exchange stream's: however many graphs a process makes (PyTorch's
    pool hands its 32 streams a priority out round robin), none of their
    streams is the card's exchange stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.parallel.ring_halo import (
        exchange_stream)
    from scaling_rgcn_training_tpu_torch.train.step_graph import CudaStepGraph

    ex = exchange_stream(torch.device("cuda", 0))
    for _ in range(70):
        g = CudaStepGraph("cuda:0")
        assert g.stream != ex
        g.close()


# -- node-major rows sharded over the cards (parallel/mesh.py NodeRows) -----

def _node_shard_setup(cards: int):
    """A mesh of ``cards`` real cards, a sparse graph's halo partition
    over it (E = N, so no per-edge tensor of a shard reaches N rows),
    the node-sharded embedding (one Parameter a card), two layers on the
    first card, a pick of labelled rows and a step function."""
    from scaling_rgcn_training_tpu_torch.models.heads import (
        node_rows_from_numpy)
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import init_rgcn_layer
    from scaling_rgcn_training_tpu_torch.parallel import halo as hp
    from scaling_rgcn_training_tpu_torch.parallel.mesh import (
        make_mesh, row_pick)
    from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer

    mesh = make_mesh(cards)
    rng = np.random.default_rng(19)
    n, slots, d = 20_000, 9, 64
    src, dst = (rng.integers(0, n, n).astype(np.int32) for _ in range(2))
    typ = rng.integers(0, slots - 1, n).astype(np.int32)
    he = hp.device_put_halo_edges(hp.halo_partition_edges(
        src, dst, typ, n, slots, cards), mesh)
    emb = node_rows_from_numpy(rng.standard_normal(
        (hp.padded_num_nodes(he), d)).astype(np.float32), mesh)
    gen = torch.Generator().manual_seed(1)
    layers = [init_rgcn_layer(gen, slots, d, 16).to(mesh.first),
              init_rgcn_layer(gen, slots, 16, 8).to(mesh.first)]
    idx = rng.permutation(n)[:512]
    pick = row_pick(idx, he.n_per, mesh.devices)
    y = torch.eye(8)[torch.arange(512) % 8].to(mesh.first)
    opt = make_optimizer([*emb.parts, *(p for l in layers
                                        for p in l.parameters())], 0.01)

    def step(keep=None):
        opt.zero_grad(set_to_none=True)
        z = hp.halo_rgcn_conv(emb, he, layers[0], mesh).map(torch.relu)
        out = hp.halo_rgcn_conv(z, he, layers[1], mesh)
        if keep is not None:
            keep.extend([z, out])
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            pick.take(out), y)
        loss.backward()
        opt.step()
        return loss.detach()

    return mesh, he, emb, opt, step


@pytest.mark.cuda
def test_cuda_node_rows_lie_on_their_cards():
    """Two cards: each shard's embedding rows, both of its Adam moments
    and both layers' outputs lie on the shard's own card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh, he, emb, opt, step = _node_shard_setup(2)
    keep = []
    step(keep)
    torch.cuda.synchronize()
    for j, dev in enumerate(mesh.devices):
        assert emb.parts[j].device == dev
        for moment in ("exp_avg", "exp_avg_sq"):
            assert opt.state[emb.parts[j]][moment].device == dev
        for rows in keep:
            assert rows.parts[j].device == dev
            assert rows.parts[j].shape[0] == he.n_per


@pytest.mark.cuda
def test_cuda_no_node_table_on_card0():
    """Two cards: no tensor of ``N * d`` elements (the whole node table at
    the embedding's width) is made on card 0 by a step, forward, backward
    or Adam (every operator's outputs seen through a dispatch mode, which
    the autograd threads of both cards inherit, and every allocation the
    caching allocator records on card 0 during the step)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh, he, emb, opt, step = _node_shard_setup(2)
    step()                                   # Adam's state, the builds
    torch.cuda.synchronize()
    whole = emb.num_rows * emb.parts[0].shape[1]
    card0 = torch.device("cuda", 0)

    class Outputs(TorchDispatchMode):
        largest = 0
        seen = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Outputs.seen += 1
                    if t.device == card0:
                        Outputs.largest = max(Outputs.largest, t.numel())
            return out

    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        with Outputs():
            step()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    assert Outputs.seen > 100
    assert 0 < Outputs.largest < whole
    allocs = [e["size"] for e in trace if e["action"] == "alloc"]
    assert allocs and max(allocs) < whole * 4


@pytest.mark.cuda
def test_cuda_two_cards_losses_match_one_card(monkeypatch):
    """``bench_scaling`` at k = 1 (one card) and k = 2 (two cards, one
    shard each): the losses within rtol 1e-5 (atol 1e-6, phase 15's
    criterion) of one card's, card 0's peak within 25% of card 1's, and
    the card-to-card MB a step counted."""
    from scaling_rgcn_training_tpu_torch import bench_scaling as bsc

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for name, value in (("BENCH_NODES", "20000"), ("BENCH_EDGES", "300000"),
                        ("BENCH_INNER", "2"), ("BENCH_CALLS", "2")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("RGCN_HALO_PALLAS_A2A", raising=False)
    recs = bsc.main(["--max-shards", "2"])
    assert [(r["devices"], r["cards"]) for r in recs] == [(1, 1), (2, 2)]
    np.testing.assert_allclose(recs[1]["losses"], recs[0]["losses"],
                               rtol=1e-5, atol=1e-6)
    peaks = recs[1]["peak_mib_per_card"]
    assert abs(peaks["0"] - peaks["1"]) <= 0.25 * peaks["1"]
    assert recs[0]["cross_card_mb_per_step"] == 0
    assert recs[1]["cross_card_mb_per_step"] > 0


def _att_case(L, d, H, n=10007, seed=0):
    """``x [L, n, d]`` and an ``MHA`` on the card (n = 10,007: the last
    tile of every tile size is partial)."""
    from scaling_rgcn_training_tpu_torch.models import attention as tatt

    g = torch.Generator().manual_seed(seed)
    x = torch.rand((L, n, d), generator=g).cuda()
    att = tatt.MHA(*(torch.randn(s, generator=g).mul(0.3).cuda()
                     for s in ((3 * d, d), (3 * d,), (d, d), (d,))))
    gy = torch.randn((n, d), generator=g).cuda()
    return x, att, gy


def _att_route(route, att, x, gy, H, rate, want_dx, seed=11):
    """One route's output, its gradients (dx first when ``want_dx``) and
    the generator's next draw."""
    from scaling_rgcn_training_tpu_torch.models import attention as tatt

    gen = torch.Generator(device="cuda").manual_seed(seed)
    xin = x.detach().requires_grad_(want_dx)
    if route == "fused":
        y = tatt.mha_first_query(att, xin, H, rate, gen)
    else:
        y = tatt.mha_self_attention(att, xin, H, rate, gen)[0]
    wrt = ((xin,) if want_dx else ()) + tuple(att.parameters())
    grads = torch.autograd.grad(y, wrt, gy)
    return y.detach(), grads, torch.rand(4, generator=gen, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("want_dx", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("d,H", [(16, 2), (63, 3), (64, 4), (128, 8)])
@pytest.mark.parametrize("L", [1, 2, 3, 4, 6])
def test_cuda_mha_first_query_matches_plain(L, d, H, rate, want_dx,
                                            monkeypatch):
    """The fused attention kernels (``mha_first_query`` on the card)
    against the plain-op route ``mha_self_attention(...)[0]`` (full f32
    cuBLAS products, TF32 off) at N = 10,007: the output, the four
    parameter gradients and, with a trainable x, dx, within the float32
    tolerance rtol 1e-4, atol 1e-4 * max|ref| (summation order differs);
    both routes leave the generator in the same state; one
    ``mha_forward`` and one ``mha_backward`` launch; ``att.fused`` counts
    the call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.utils import tracing

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x, att, gy = _att_case(L, d, H)
    ref = _att_route("plain", att, x, gy, H, rate, want_dx)
    before, fused = dict(cuda_build.LAUNCHES), tracing.counters().get(
        "att.fused", 0)
    got = _att_route("fused", att, x, gy, H, rate, want_dx)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["mha_forward"] == before["mha_forward"] + 1
    assert cuda_build.LAUNCHES["mha_backward"] == before["mha_backward"] + 1
    assert tracing.counters()["att.fused"] == fused + 1
    for a, b in zip((got[0], *got[1]), (ref[0], *ref[1])):
        torch.testing.assert_close(a, b, **_tol("float32", b))
    assert torch.equal(got[2], ref[2])


@pytest.mark.cuda
def test_cuda_mha_first_query_graph_and_bits():
    """At AM's widths (3 summaries, 3 heads of 21) with dropout: two
    eager calls from one seed give the same bits (no atomics), and the
    forward and backward captured as one CUDA graph (the generator
    registered) replay the eager calls' bits, step by step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.models import attention as tatt

    x, att, gy = _att_case(3, 63, 3)
    params = tuple(att.parameters())
    gen = torch.Generator(device="cuda").manual_seed(5)

    def step():
        y = tatt.mha_first_query(att, x, 3, 0.2, gen)
        return (y.detach(), *torch.autograd.grad(y, params, gy))

    def eager():
        gen.manual_seed(5)
        return [[t.clone() for t in step()] for _ in range(2)]

    first, second = eager(), eager()
    assert all(torch.equal(a, b) for s1, s2 in zip(first, second)
               for a, b in zip(s1, s2))
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = step()
    gen.manual_seed(5)
    for want in first:
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("L,d,H,dtype", [(9, 16, 2, "float32"),
                                         (3, 130, 2, "float32"),
                                         (3, 63, 3, "float64")])
def test_cuda_mha_first_query_outside_bounds_is_plain(L, d, H, dtype):
    """A shape or type outside the kernels' bounds (L > 8, d > 128,
    float64) takes the plain-op route on the card: ``att.plain`` counts
    it, no attention kernel launches, and the row is
    ``mha_self_attention(...)[0]``'s bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.models import attention as tatt
    from scaling_rgcn_training_tpu_torch.utils import tracing

    x, att, _ = _att_case(L, d, H, n=300)
    dt = getattr(torch, dtype)
    x, att = x.to(dt), att.to(dt)
    before, plain = dict(cuda_build.LAUNCHES), tracing.counters().get(
        "att.plain", 0)
    got = tatt.mha_first_query(att, x, H, 0.2,
                               torch.Generator(device="cuda").manual_seed(1))
    want = tatt.mha_self_attention(
        att, x, H, 0.2, torch.Generator(device="cuda").manual_seed(1))[0]
    assert tracing.counters()["att.plain"] == plain + 1
    assert cuda_build.LAUNCHES == before
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_mha_every_shape_inside_the_bounds_has_a_plan():
    """Every shape ``fused_ok`` takes (L <= 8, H <= 8, d <= 128, d % H ==
    0) has a tile that fits in shared memory for the forward and for the
    backward with and without dx, with at least one block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.ops import attention_kernels as tak

    lib = tak._lib()
    for L in range(1, tak.MAX_SUMS + 1):
        for H in range(1, tak.MAX_SUMS + 1):
            for d in range(H, tak.MAX_WIDTH + 1, H):
                x = torch.empty((L, 1000, d), device="cuda")
                for which in (-1, 0, 1):
                    T, _, smem, blocks, _ = tak._plan(lib, x, H, which)
                    assert T >= 4 and 0 < smem <= 232448 and blocks >= 1


@pytest.mark.cuda
def test_cuda_mha_first_query_strided_input_is_fused():
    """A strided float32 input inside the bounds (x a transposed view,
    ``[B, L, d]`` storage) takes the fused route, not the plain one: the
    same bits as from its contiguous copy, output and gradients, and
    ``att.plain`` does not move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.models import attention as tatt
    from scaling_rgcn_training_tpu_torch.utils import tracing

    x, att, gy = _att_case(3, 63, 3)
    strided = x.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    params = tuple(att.parameters())
    plain = tracing.counters().get("att.plain", 0)
    outs = []
    for xin in (x, strided):
        gen = torch.Generator(device="cuda").manual_seed(3)
        y = tatt.mha_first_query(att, xin, 3, 0.2, gen)
        outs.append((y.detach(), *torch.autograd.grad(y, params, gy)))
    assert tracing.counters().get("att.plain", 0) == plain
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def _basis_case(B, H, n=700, e=6000, slots=29, seed=0):
    """A graph whose rows have 0, 1 and many edges (node 0 sends and takes
    a tenth of them, nodes past ``n - 50`` none, node ``n - 51`` exactly
    one each way) and a featureless basis layer's float32 leaves (bases
    ``[n, B, H]``)."""
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges

    rng = np.random.default_rng(seed)
    live = n - 51
    src = rng.integers(1, live, e).astype(np.int32)
    dst = rng.integers(1, live, e).astype(np.int32)
    hub = rng.random(e) < 0.1
    src[hub], dst[rng.random(e) < 0.1] = 0, 0
    src[:1], dst[1:2] = live, live
    typ = rng.integers(0, slots, e).astype(np.int32)
    typ[typ % 7 == 3] = 5           # some relations without edges
    edges = build_rel_edges(src, dst, typ, n, slots, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    leaf = lambda *shape: torch.rand(shape, generator=g, device="cuda") - 0.5
    return edges, (leaf(n, B, H), leaf(slots, B), leaf(n, H), leaf(H))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(40, 10), (3, 6), (33, 1), (64, 16),
                                 (17, 11)])
def test_cuda_basis_kernels_match_plain(B, H):
    """``ops/basis_kernels.py``: the layer's output and the gradients of
    its four leaves from the kernels against the plain route's autograd
    on the card, on rows of 0, 1 and many edges; one launch a call each
    way; the same bits on two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.ops import basis_kernels as bk

    edges, leaves = _basis_case(B, H)
    assert bk.refusal(*leaves, edges.span) is None
    gy = torch.randn(leaves[2].shape, device="cuda")
    params = [t.clone().requires_grad_() for t in leaves]
    want = bk.basis_conv_plain(*params, edges)
    refs = (want.detach(), *torch.autograd.grad(want, params, gy))
    runs = []
    before = dict(cuda_build.LAUNCHES)
    for _ in range(2):
        params = [t.clone().requires_grad_() for t in leaves]
        got = bk.basis_conv(edges, *params)
        runs.append((got.detach(), *torch.autograd.grad(got, params, gy)))
    assert cuda_build.LAUNCHES["basis_forward"] == \
        before["basis_forward"] + 2
    assert cuda_build.LAUNCHES["basis_backward"] == \
        before["basis_backward"] + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    for a, b in zip(runs[0], refs):
        tol = 1e-4 * float(b.abs().max())
        assert torch.allclose(a, b, rtol=1e-4, atol=tol)
    # the node with no edges: root + bias, and no gradient on its bases
    assert torch.equal(runs[0][0][-1], leaves[2][-1] + leaves[3])
    assert not runs[0][1][-1].any()


@pytest.mark.cuda
def test_cuda_basis_conv_refuses_what_the_kernels_cannot_take():
    """On a card ``basis_conv`` never takes the plain route: too many
    bases, too wide an output, a float64 leaf or edges without the span
    plan raise a ValueError that names the limit, and count no call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scaling_rgcn_training_tpu_torch.ops import basis_kernels as bk
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
    from scaling_rgcn_training_tpu_torch.utils import tracing

    edges, leaves = _basis_case(4, 4)
    no_span = build_rel_edges(
        *(t.cpu().numpy() for t in (edges.src, edges.dst, edges.rel)),
        edges.num_nodes, edges.num_slots, device="cuda", span=False)
    float64 = (leaves[0].double(), *leaves[1:])
    tracing.reset()
    for (e, layer), words in ((_basis_case(65, 4), "65 bases"),
                              (_basis_case(4, 17), "width 17"),
                              ((edges, float64), "float64"),
                              ((no_span, leaves), "no span plan")):
        with pytest.raises(ValueError, match=words):
            bk.basis_conv(e, *layer)
    assert not any(k.startswith("basis.") for k in tracing.counters())
    tracing.reset()
