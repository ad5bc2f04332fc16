"""Port ``rgcn_conv`` against the JAX package's ``rgcn_conv`` on the CPU.

Same inputs from one numpy seed; the JAX values and gradients come from
``rgcn_conv`` and ``jax.grad``, the port's from its autograd Function (the
plain span versions on the CPU). Tolerances: float32 rtol 1e-5 with atol
1e-5 * max|ref|; bfloat16 edge streams 3e-2 * max|ref| (the two packages
round to bf16 at different places).
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# the JAX ops package exports the function rgcn_conv under the module's name
jconv = importlib.import_module("scaling_rgcn_training_tpu.ops.rgcn_conv")
from scaling_rgcn_training_tpu_torch.ops import rgcn_conv as tconv


def _edges(rng, n, e, slots):
    """Random edges; nodes n-5.. and relation 1 get none."""
    src = rng.integers(0, n - 5, e).astype(np.int32)
    dst = rng.integers(0, n - 5, e).astype(np.int32)
    typ = rng.choice([r for r in range(slots) if r != 1], e).astype(np.int32)
    return src, dst, typ


def _params(rng, decomp, slots, d_in, d_out):
    """JAX layer params as numpy, in each weight decomposition."""
    comp = None
    if decomp == "basis":
        w = rng.standard_normal((3, d_in, d_out)) * 0.3
        comp = rng.standard_normal((slots, 3)) * 0.5
    elif decomp == "blocks":
        w = rng.standard_normal((slots, 2, d_in // 2, d_out // 2)) * 0.3
    else:
        w = rng.standard_normal((slots, d_in, d_out)) * 0.3
    root = rng.standard_normal((d_in, d_out)) * 0.3
    bias = rng.standard_normal(d_out) * 0.1
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    return f32(w), f32(root), f32(bias), f32(comp)


@pytest.mark.parametrize("compute_dtype,tol", [(None, 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("decomp", ["full", "basis", "blocks"])
def test_conv_values_and_grads_match_jax(decomp, compute_dtype, tol):
    rng = np.random.default_rng(11)
    n, e, slots, d_in, d_out = 120, 900, 7, 12, 6
    src, dst, typ = _edges(rng, n, e, slots)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    g = rng.standard_normal((n, d_out)).astype(np.float32)
    w, root, bias, comp = _params(rng, decomp, slots, d_in, d_out)

    jedges = jconv.build_rel_edges(src, dst, typ, n, slots)
    jcd = None if compute_dtype is None else jnp.bfloat16

    def jloss(xx, ww, rr, bb, cc):
        p = jconv.RGCNLayerParams(ww, rr, bb, cc)
        out = jconv.rgcn_conv(xx, jedges, p, backend="gather",
                              compute_dtype=jcd)
        return jnp.sum(out * g), out

    jargs = [jnp.asarray(a) if a is not None else None
             for a in (x, w, root, bias, comp)]
    argnums = (0, 1, 2, 3) + ((4,) if comp is not None else ())
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums, has_aux=True)(*jargs)

    tedges = tconv.build_rel_edges(src, dst, typ, n, slots)
    layer = tconv.RGCNLayer(*(torch.tensor(a) if a is not None else None
                              for a in (w, root, bias, comp)))
    xt = torch.tensor(x, requires_grad=True)
    out = tconv.rgcn_conv(xt, tedges, layer,
                          None if compute_dtype is None else torch.bfloat16)
    (out * torch.tensor(g)).sum().backward()
    tgrads = [xt.grad, layer.weight.grad, layer.root.grad, layer.bias.grad]
    if comp is not None:
        tgrads.append(layer.comp.grad)

    assert out.dtype == torch.float32
    for name, got, ref in zip(["out", "x", "weight", "root", "bias", "comp"],
                              [out, *tgrads], [jout, *jgrads]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            got.detach().numpy(), ref, rtol=tol,
            atol=tol * max(np.abs(ref).max(), 1e-6), err_msg=name)


@pytest.mark.parametrize("decomp", ["full", "basis", "blocks"])
def test_materialize_weight_matches_jax(decomp):
    rng = np.random.default_rng(12)
    w, root, bias, comp = _params(rng, decomp, 5, 8, 4)
    ref = jconv.materialize_weight(jconv.RGCNLayerParams(
        jnp.asarray(w), jnp.asarray(root), jnp.asarray(bias),
        None if comp is None else jnp.asarray(comp)))
    got = tconv.materialize_weight(tconv.RGCNLayer(
        torch.tensor(w), torch.tensor(root), torch.tensor(bias),
        None if comp is None else torch.tensor(comp)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"num_bases": 3}, {"num_blocks": 2}])
def test_init_rgcn_layer_shapes_and_bounds_match_jax(kw):
    """Same shapes as the JAX init; values inside the torch-matching
    bounds (the two generators give different numbers)."""
    slots, d_in, d_out = 9, 16, 6
    ref = jconv.init_rgcn_layer(jax.random.key(0), slots, d_in, d_out, **kw)
    got = tconv.init_rgcn_layer(torch.Generator().manual_seed(0), slots,
                                d_in, d_out, **kw)
    for name in ("weight", "root", "bias", "comp"):
        r, t = getattr(ref, name), getattr(got, name)
        assert (r is None) == (t is None), name
        if r is not None:
            assert tuple(t.shape) == tuple(r.shape), name
    fan = int(np.prod(got.weight.shape[1:]))
    assert got.weight.abs().max() <= np.sqrt(6.0 / fan)
    assert got.root.abs().max() <= np.sqrt(6.0 / (d_in + d_out))
    assert not got.bias.any()


def test_mean_coefficient_matches_jax():
    """norm_e = 1 / deg_r(dst_e), edge by edge."""
    rng = np.random.default_rng(13)
    src, dst, typ = _edges(rng, 60, 400, 5)
    jedges = jconv._build_rel_edges_host(src, dst, typ, 60, 5)
    real = jedges.norm > 0
    ref = sorted(zip(jedges.src[real].tolist(), jedges.dst[real].tolist(),
                     jedges.rel[real].tolist(), jedges.norm[real].tolist()))
    plan = tconv.build_rel_edges(src, dst, typ, 60, 5)
    got = sorted(zip(plan.rel_src.tolist(), plan.rel_dst.tolist(),
                     np.repeat(np.arange(5), np.diff(plan.rel_edge_ptr)).tolist(),
                     plan.rel_norm.tolist()))
    assert got == ref
