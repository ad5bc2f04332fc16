"""Port non-fused conv (edge and prematmul modes), relational attention, the
``auto`` rule and the non-fused trainer against the JAX package on the CPU.

Same inputs from one numpy seed. JAX runs ``rgcn_conv(mode=...,
backend="gather")`` (or ``aggr="attention"``) with ``jax.grad``; the port
runs each of its grouped-matmul backends, whose kernels take their plain
versions on the CPU. Tolerances: float32 rtol 1e-5 with atol
1e-5 * max|ref| (summation order differs); bfloat16 edge streams
3e-2 * max|ref| (the two packages round to bf16 at other points); the
5-epoch loss series rtol 1e-4, as tests/test_torch_port_train.py.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.graphs.device import build_device_graph as j_build
from scaling_rgcn_training_tpu.models import heads as jheads
from scaling_rgcn_training_tpu.train import losses as jlosses
from scaling_rgcn_training_tpu.train.trainer import Trainer as JTrainer
from scaling_rgcn_training_tpu_torch.graphs.device import build_device_graph as t_build
from scaling_rgcn_training_tpu_torch.models.heads import emb_model_from_numpy
from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.ops import rgcn_conv as tconv
from scaling_rgcn_training_tpu_torch.ops import sddmm as tsddmm
from scaling_rgcn_training_tpu_torch.train import losses as tlosses
from scaling_rgcn_training_tpu_torch.train.trainer import Trainer as TTrainer
from tests.test_torch_port_conv import _edges, _params
from tests.test_torch_port_train import _graph

# the JAX ops package exports functions under these modules' names
jconv = importlib.import_module("scaling_rgcn_training_tpu.ops.rgcn_conv")
jsddmm = importlib.import_module("scaling_rgcn_training_tpu.ops.sddmm")


def _conv_pair(rng, n, e, slots, d_in, d_out, decomp="full"):
    src, dst, typ = _edges(rng, n, e, slots)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    g = rng.standard_normal((n, d_out)).astype(np.float32)
    return (src, dst, typ), x, g, _params(rng, decomp, slots, d_in, d_out)


def _jax_conv(edge_arrays, n, slots, x, g, params, compute_dtype, **kw):
    jedges = jconv.build_rel_edges(*edge_arrays, n, slots)
    jcd = None if compute_dtype is None else jnp.bfloat16

    def loss(xx, ww, rr, bb):
        p = jconv.RGCNLayerParams(ww, rr, bb, None)
        out = jconv.rgcn_conv(xx, jedges, p, backend="gather",
                              compute_dtype=jcd, **kw)
        return jnp.sum(out * g), out

    args = [jnp.asarray(a) for a in (x, *params[:3])]
    (_, out), grads = jax.value_and_grad(loss, (0, 1, 2, 3), has_aux=True)(*args)
    return [out, *grads]


def _port_conv(edges, x, g, params, compute_dtype, **kw):
    layer = tconv.RGCNLayer(*(torch.tensor(a) for a in params[:3]))
    xt = torch.tensor(x, requires_grad=True)
    out = tconv.rgcn_conv(xt, edges, layer, compute_dtype=None if compute_dtype
                          is None else torch.bfloat16, **kw)
    (out * torch.tensor(g)).sum().backward()
    assert out.dtype == torch.float32
    return [out, xt.grad, layer.weight.grad, layer.root.grad, layer.bias.grad]


def _assert_all_close(got, ref, tol):
    for name, a, b in zip(["out", "x", "weight", "root", "bias"], got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=tol,
                                   atol=tol * max(np.abs(b).max(), 1e-6),
                                   err_msg=name)


DTYPES = [(None, 1e-5), ("bfloat16", 3e-2)]


@pytest.mark.parametrize("compute_dtype,tol", DTYPES)
@pytest.mark.parametrize("backend", ["gather", "ragged", "pallas"])
@pytest.mark.parametrize("mode", ["edge", "prematmul"])
def test_edge_modes_match_jax(mode, backend, compute_dtype, tol):
    rng = np.random.default_rng(21)
    n, e, slots, d_in, d_out = 90, 700, 7, 12, 6
    arrays, x, g, params = _conv_pair(rng, n, e, slots, d_in, d_out)
    ref = _jax_conv(arrays, n, slots, x, g, params, compute_dtype, mode=mode)
    edges = tconv.build_rel_edges(*arrays, n, slots, span=False)
    got = _port_conv(edges, x, g, params, compute_dtype, mode=mode,
                     backend=backend)
    _assert_all_close(got, ref, tol)


@pytest.mark.parametrize("compute_dtype,tol", DTYPES)
@pytest.mark.parametrize("backend", ["gather", "ragged", "pallas"])
def test_attention_matches_jax(backend, compute_dtype, tol):
    rng = np.random.default_rng(22)
    n, e, slots, d_in, d_out = 80, 600, 5, 10, 7
    arrays, x, g, params = _conv_pair(rng, n, e, slots, d_in, d_out)
    ref = _jax_conv(arrays, n, slots, x, g, params, compute_dtype,
                    aggr="attention")
    edges = tconv.build_rel_edges(*arrays, n, slots)
    got = _port_conv(edges, x, g, params, compute_dtype, aggr="attention",
                     backend=backend)
    _assert_all_close(got, ref, tol)


@pytest.mark.parametrize("backend", ["gather", "ragged", "pallas"])
def test_sddmm_matches_jax(backend):
    """Per-edge scores; the two packages order edges differently within a
    relation, so they are compared as sorted (src, dst, rel, score)."""
    rng = np.random.default_rng(24)
    n, e, slots, d_x, d_y = 50, 300, 5, 6, 4
    src, dst, typ = _edges(rng, n, e, slots)
    x, x2 = (rng.standard_normal((n, d_x)).astype(np.float32) for _ in "ab")
    y = rng.standard_normal((n, d_y)).astype(np.float32)
    w = rng.standard_normal((slots, d_x, d_y)).astype(np.float32)
    ref = jsddmm.sddmm(jnp.asarray(x), jnp.asarray(x2), jnp.asarray(src),
                       jnp.asarray(dst))
    got = tsddmm.sddmm(torch.tensor(x), torch.tensor(x2),
                       torch.tensor(src).long(), torch.tensor(dst).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    jedges = jconv.build_rel_edges(src, dst, typ, n, slots)
    jr = np.asarray(jsddmm.sddmm_rel(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(w), jedges, backend="gather"))
    real = np.asarray(jedges.norm) > 0
    ref = sorted(zip(*(np.asarray(a)[real].tolist() for a in
                       (jedges.src, jedges.dst, jedges.rel)), jr[real].tolist()))
    tedges = tconv.build_rel_edges(src, dst, typ, n, slots)
    tr = tsddmm.sddmm_rel(torch.tensor(x), torch.tensor(y), torch.tensor(w),
                          tedges, backend=backend)
    got = sorted(zip(tedges.src.tolist(), tedges.dst.tolist(),
                     tedges.rel.tolist(), tr.tolist()))
    assert [g[:3] for g in got] == [r[:3] for r in ref]
    np.testing.assert_allclose([g[3] for g in got], [r[3] for r in ref],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d_in,d_out,span,expect", [
    (12, 6, True, "fused"),
    (12, 6, False, None),          # no span plan: the traffic rule
    (130, 8, True, None),          # wider than the span kernels take
    (72, 64, True, None),          # d_in * d_out > 4096
])
def test_auto_mode(d_in, d_out, span, expect):
    """``auto`` is fused only with a span plan at widths the span kernels
    take, else the JAX traffic rule; the wide layer matches JAX's conv."""
    rng = np.random.default_rng(d_in + d_out)
    n, e, slots = 40, 300, 5
    arrays, x, g, params = _conv_pair(rng, n, e, slots, d_in, d_out)
    edges = tconv.build_rel_edges(*arrays, n, slots, span=span)
    mode = tconv.auto_mode(edges, d_in, d_out)
    traffic = jconv._edge_traffic_mode(n, slots, e, d_in, d_out)
    assert mode == (expect or traffic)
    assert tconv._edge_traffic_mode(n, slots, e, d_in, d_out) == traffic
    got = _port_conv(edges, x, g, params, None)
    _assert_all_close(got, _jax_conv(arrays, n, slots, x, g, params, None), 1e-5)


def test_rel_edges_share_the_span_plan():
    """With a span plan the edge object holds no second copy of the edges;
    ``rel`` and the permutations are built at first non-fused use only, and
    equal those of edges built without the plan."""
    rng = np.random.default_rng(25)
    n, e, slots = 40, 300, 5
    src, dst, typ = _edges(rng, n, e, slots)
    edges = tconv.build_rel_edges(src, dst, typ, n, slots)
    bare = tconv.build_rel_edges(src, dst, typ, n, slots, span=False)
    plan = edges.span
    for mine, its in (("src", "rel_src"), ("dst", "rel_dst"), ("norm", "rel_norm"),
                      ("dst_rowptr", "fwd_rowptr"), ("src_rowptr", "bwd_rowptr")):
        assert getattr(edges, mine) is getattr(plan, its)
    assert edges.group_offsets == bare.group_offsets == plan.rel_edge_ptr
    x = torch.tensor(rng.standard_normal((n, 6)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((slots, 6, 3)), dtype=torch.float32,
                     requires_grad=True)
    tconv.relational_aggregate(x, w, edges, "fused").sum().backward()
    assert not {"rel", "dst_perm", "src_perm"} & set(vars(edges))
    for name in ("src", "dst", "norm", "group_sizes", "dst_rowptr",
                 "src_rowptr", "rel", "dst_perm", "src_perm"):
        assert torch.equal(getattr(edges, name), getattr(bare, name)), name
    assert edges.src.dtype == edges.dst_perm.dtype == torch.int32
    np.testing.assert_array_equal(bare.dst[bare.dst_perm].numpy(), np.sort(dst))
    np.testing.assert_array_equal(bare.src[bare.src_perm].numpy(), np.sort(src))
    order = np.lexsort((src, typ))
    np.testing.assert_array_equal(bare.rel.numpy(), typ[order])
    np.testing.assert_array_equal(bare.src.numpy(), src[order])


def test_edge_mode_gradcheck():
    """The non-fused Function's hand-written backward, in float64."""
    rng = np.random.default_rng(23)
    n, e, slots = 20, 90, 4
    src, dst, rel = _edges(rng, n, e, slots)
    edges = tconv.plan_edges(src, dst, rel, rng.random(e), n, slots, span=False)
    x = torch.tensor(rng.standard_normal((n, 4)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((slots, 4, 3)), requires_grad=True)
    for mode in ("edge", "prematmul"):
        assert torch.autograd.gradcheck(
            lambda a, b: tconv.relational_aggregate(a, b, edges, mode, "pallas"),
            (x, w))
    with pytest.raises(ValueError, match="span=True"):
        tconv.relational_aggregate(x, w, edges, "fused")


@pytest.mark.parametrize("aggr,backend", [("mean", "gather"),
                                          ("mean", "pallas"),
                                          ("attention", "gather")])
def test_fit_non_fused_matches_jax(aggr, backend):
    """5 epochs of ``Trainer.fit`` on edges without a span plan (so the
    port's conv takes the edge mode) against the JAX trainer's."""
    g = _graph(seed=1)
    emb, hl, epochs = 12, 8, 5
    params = jheads.init_emb_model(jax.random.key(4), g.num_relation_slots,
                                   hl, g.num_classes, g.num_nodes, emb)
    jt = JTrainer(None, hl, epochs, emb, 0.01, 5e-5, backend="gather",
                  aggr=aggr)
    jloss, act = jlosses.get_loss("SYNTH", sum_model=False)
    _, jaccs, jl, _, _ = jt.fit(params, jheads.apply_emb_model, j_build(g),
                                jloss, act, sum_graph=False, verbose=False)

    model = emb_model_from_numpy(np.asarray(params.embedding),
                                 list(params.rgcn1), list(params.rgcn2))
    graph = t_build(g, "cpu")
    graph = dataclasses.replace(graph, edges=tconv.build_rel_edges(
        g.edge_src, g.edge_dst, g.edge_type, g.num_nodes,
        g.num_relation_slots, span=False))
    tt = TTrainer(None, hl, epochs, emb, 0.01, 5e-5, device="cpu",
                  backend=backend, aggr=aggr)
    tloss, tact = tlosses.get_loss("SYNTH", sum_model=False)
    before = dict(cuda_build.LAUNCHES)
    _, taccs, tl, _, _ = tt.fit(model, graph, tloss, tact, sum_graph=False,
                                verbose=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(taccs, jaccs, rtol=0,
                               atol=1.0 / len(g.x_val) + 1e-7)
    assert cuda_build.LAUNCHES == before     # plain versions on the CPU


def test_trainer_rejects_unknown_backend_and_aggr():
    with pytest.raises(ValueError, match="backend"):
        TTrainer(None, 4, 1, 4, 0.01, 0.0, device="cpu", backend="xla")
    with pytest.raises(ValueError, match="aggr"):
        TTrainer(None, 4, 1, 4, 0.01, 0.0, device="cpu", aggr="sum")
