"""Port MLP and attention heads against the JAX package's.

Multi-head self-attention, the MLP and attention models' logits and
gradients (JAX parameters carried across with ``*_model_from_numpy``), the
concat and stack transfer tricks, and ``Trainer.fit`` of both heads (JAX on
the CPU, the port with the plain span versions) from the same parameters.
``jax.random`` and ``torch`` cannot draw the same dropout mask, so the
attention head is compared with dropout off on both sides (a monkeypatch
of the JAX heads module's ``mha_self_attention``; no JAX file changes);
the port's dropout is checked by its mean and its determinism under one
seed. ``mha_first_query`` (the attention model's route) is checked for
its route counters and its generator's state, and the fused kernels'
algebra, written here in plain tensor ops, against autograd in float64.
The featureless basis model (``FeaturelessModel``) against the JAX
package's basis ``rgcn_conv`` over the one-hot input. Tolerances: attention and
logits float32 rtol 1e-5 with atol 1e-6
(summation order); gradients rtol 1e-4 with atol 1e-6 * max|ref|; loss
series rtol 1e-4 and final parameters as in ``test_torch_port_train.py``.
"""

import importlib
import math
import os
from types import SimpleNamespace
from typing import Optional

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.graphs import dataset as jdataset
from scaling_rgcn_training_tpu.graphs import synthetic as jsynth
from scaling_rgcn_training_tpu.graphs.device import build_device_graph as j_build
from scaling_rgcn_training_tpu.models import attention as jatt
from scaling_rgcn_training_tpu.models import heads as jheads
from scaling_rgcn_training_tpu.train import losses as jlosses
from scaling_rgcn_training_tpu.train import trainer as jtrainer
from scaling_rgcn_training_tpu.train import transfer as jtransfer
from scaling_rgcn_training_tpu_torch.graphs import dataset as tdataset
from scaling_rgcn_training_tpu_torch.graphs import synthetic as tsynth
from scaling_rgcn_training_tpu_torch.graphs.device import build_device_graph as t_build
from scaling_rgcn_training_tpu_torch.models import attention as tatt
from scaling_rgcn_training_tpu_torch.models import heads as theads
from scaling_rgcn_training_tpu_torch.train import losses as tlosses
from scaling_rgcn_training_tpu_torch.train import transfer as ttransfer
from scaling_rgcn_training_tpu_torch.train.trainer import (
    Trainer as TTrainer, count_trainable_parameters as t_count)
from scaling_rgcn_training_tpu_torch.utils import tracing

K, EMB, HL = 3, 12, 8


def _graph(seed=0, n=200, e=1500, r=3, c=4):
    rng = np.random.default_rng(seed)
    labelled = rng.choice(n, 90, replace=False)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, 90)]
    return SimpleNamespace(
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_type=rng.integers(0, 2 * r, e).astype(np.int32),
        num_nodes=n, num_relation_slots=2 * r + 1, num_classes=c,
        x_train=labelled[:60].astype(np.int32), y_train=y[:60],
        x_val=labelled[60:].astype(np.int32), y_val=y[60:],
        x_test=None, y_test=None)


def _leaves(p):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(p)]


def _jax_params(head, g, seed=3):
    """JAX head parameters with a transferred-shape embedding (MLP
    ``[N, K*d]``, attention ``[K, N, d]``) drawn with numpy."""
    init = {"mlp": jheads.init_mlp_model, "attention": jheads.init_att_model}
    params = init[head](jax.random.key(seed), g.num_relation_slots, HL,
                        g.num_classes, g.num_nodes, EMB, num_sums=K)
    shape = (g.num_nodes, K * EMB) if head == "mlp" else (K, g.num_nodes, EMB)
    emb = np.random.default_rng(seed).random(shape).astype(np.float32)
    return params._replace(embedding=jnp.asarray(emb))


def _port_model(head, params):
    rgcn = [list(params.rgcn1), list(params.rgcn2)]
    if head == "mlp":
        return theads.mlp_model_from_numpy(
            *(np.asarray(a) for a in params[:5]), *rgcn)
    return theads.att_model_from_numpy(
        np.asarray(params.embedding), [np.asarray(a) for a in params.att],
        *rgcn)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """The JAX attention head with its dropout off (fresh jitted fits)."""
    real = jheads.mha_self_attention
    monkeypatch.setattr(jheads, "mha_self_attention",
                        lambda p, x, num_heads, dropout_rate=0.0, dropout_rng=None:
                        real(p, x, num_heads, 0.0, None))
    jtrainer._cached_fit_fn.cache_clear()
    yield
    jtrainer._cached_fit_fn.cache_clear()


@pytest.mark.parametrize("seq,batch,d,heads", [(3, 50, 12, 3), (4, 9, 16, 4),
                                               (1, 7, 6, 1), (5, 20, 10, 5)])
def test_mha_matches_jax(seq, batch, d, heads):
    rng = np.random.default_rng(seq * d)
    x = rng.standard_normal((seq, batch, d)).astype(np.float32)
    leaves = [rng.standard_normal(s).astype(np.float32) * 0.3
              for s in ((3 * d, d), (3 * d,), (d, d), (d,))]
    ref = np.asarray(jatt.mha_self_attention(
        jatt.MHAParams(*map(jnp.asarray, leaves)), jnp.asarray(x), heads))
    got = tatt.mha_self_attention(
        tatt.MHA(*map(torch.tensor, leaves)), torch.tensor(x), heads)
    assert got.shape == (seq, batch, d)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-6)


# (L, B, d, H): L = 1, d not a multiple of 32, AM's 3 heads of 21, d = 128
FIRST_QUERY_SHAPES = [(3, 50, 63, 3), (1, 17, 16, 2), (4, 33, 20, 4),
                      (2, 9, 128, 8), (6, 12, 10, 5)]


def _mha_case(L, B, d, H, dtype=torch.float32):
    rng = np.random.default_rng(L * 1000 + d)
    x = torch.tensor(rng.standard_normal((L, B, d)), dtype=dtype)
    att = tatt.MHA(*(torch.tensor(rng.standard_normal(s) * 0.3, dtype=dtype)
                     for s in ((3 * d, d), (3 * d,), (d, d), (d,))))
    return x, att


@pytest.mark.parametrize("L,B,d,H", FIRST_QUERY_SHAPES)
def test_mha_first_query_is_the_first_row(L, B, d, H):
    """On the CPU ``mha_first_query`` takes the plain route: ``att.plain``
    counts each call and ``att.fused`` none. Its output and four parameter
    gradients are ``mha_self_attention(...)[0]``'s, and with dropout it
    leaves its generator where an identically seeded one fed to
    ``mha_self_attention`` is left (the next draws are equal). On the CPU
    the row is that very call, so the fused route's equality is held on
    the card (``test_torch_port_cuda.py``) and its algebra below."""
    x, att = _mha_case(L, B, d, H)
    gy = torch.tensor(np.random.default_rng(d).standard_normal((B, d)),
                      dtype=torch.float32)
    params = tuple(att.parameters())
    for rate in (0.0, 0.2):
        gens = [torch.Generator().manual_seed(7) for _ in range(2)]
        before = tracing.counters()
        y = tatt.mha_first_query(att, x, H, rate, gens[0])
        after = tracing.counters()
        assert after.get("att.plain", 0) == before.get("att.plain", 0) + 1
        assert after.get("att.fused", 0) == before.get("att.fused", 0)
        ref = tatt.mha_self_attention(att, x, H, rate, gens[1])[0]
        assert torch.equal(y, ref)
        for a, b in zip(torch.autograd.grad(y, params, gy),
                        torch.autograd.grad(ref, params, gy)):
            assert torch.equal(a, b)
        assert torch.equal(torch.rand(5, generator=gens[0]),
                           torch.rand(5, generator=gens[1]))


def _forward_parts(x, in_w, in_b, draw, p, num_heads):
    """The fused forward's intermediates, computed as the kernels do."""
    L, B, d = x.shape
    H, dh = num_heads, d // num_heads
    wq, wk, wv = in_w.split(d)
    bq, bk, bv = in_b.split(d)
    qh = (x[0] @ wq.T + bq).reshape(B, H, dh)
    qt = torch.einsum("bhe,hei->bhi", qh, wk.reshape(H, dh, d))
    c = (qh * bk.reshape(H, dh)).sum(-1)
    s = (torch.einsum("bhi,lbi->bhl", qt, x) + c[..., None]) / math.sqrt(dh)
    a = torch.softmax(s, dim=-1)
    keep = None if draw is None else draw[:, :, 0, :] >= p
    ad = a if keep is None else torch.where(keep, a / (1.0 - p),
                                            torch.zeros_like(a))
    xbar = torch.einsum("bhl,lbi->bhi", ad, x)
    S = ad.sum(-1)
    o = torch.einsum("bhi,hei->bhe", xbar, wv.reshape(H, dh, d)) \
        + S[..., None] * bv.reshape(H, dh)
    return dict(qh=qh, qt=qt, a=a, keep=keep, ad=ad, xbar=xbar, S=S, o=o)


def _first_query_plain(x: torch.Tensor, in_w: torch.Tensor,
                       in_b: torch.Tensor, out_w: torch.Tensor,
                       out_b: torch.Tensor, draw: Optional[torch.Tensor],
                       dropout_rate: float, num_heads: int) -> torch.Tensor:
    """``ops/attention_kernels.py`` ``FirstQuery``'s forward by the
    kernels' algebra in plain tensor ops: ``q`` of summary 0, ``qt_h = Wk_h^T q_h``, scores ``(qt_h . x_j +
    q_h . bk_h) / sqrt(dh)``, ``xbar_h = sum_j a'_hj x_j``, ``o_h = Wv_h
    xbar_h + S_h bv_h``, ``y = Wo o + bo``."""
    B, d = x.shape[1:]
    o = _forward_parts(x, in_w, in_b, draw, dropout_rate, num_heads)["o"]
    return o.reshape(B, d) @ out_w.T + out_b


def _first_query_backward_plain(gy: torch.Tensor, x: torch.Tensor,
                                in_w: torch.Tensor, in_b: torch.Tensor,
                                out_w: torch.Tensor, out_b: torch.Tensor,
                                draw: Optional[torch.Tensor],
                                dropout_rate: float, num_heads: int):
    """``mha_backward``'s formulas in plain tensor ops: ``(dx, d_in_w,
    d_in_b, d_out_w, d_out_b)`` for ``gy [B, d]``, from the chain
    recomputed as :func:`_first_query_plain`."""
    L, B, d = x.shape
    H, dh = num_heads, d // num_heads
    p = dropout_rate
    wq, wk, wv = in_w.split(d)
    bk, bv = in_b.split(d)[1:]
    f = _forward_parts(x, in_w, in_b, draw, p, num_heads)
    qh, qt, a, keep, ad, xbar, S = (f[k] for k in ("qh", "qt", "a", "keep",
                                                   "ad", "xbar", "S"))
    d_out_w = gy.T @ f["o"].reshape(B, d)
    d_out_b = gy.sum(0)
    go = (gy @ out_w).reshape(B, H, dh)
    dwv = torch.einsum("bhe,bhi->hei", go, xbar).reshape(d, d)
    dbv = (go * S[..., None]).sum(0).reshape(d)
    gxbar = torch.einsum("bhe,hei->bhi", go, wv.reshape(H, dh, d))
    gad = torch.einsum("bhi,lbi->bhl", gxbar, x) \
        + (go * bv.reshape(H, dh)).sum(-1)[..., None]
    ga = gad if keep is None else torch.where(keep, gad / (1.0 - p),
                                              torch.zeros_like(gad))
    gs = a * (ga - (a * ga).sum(-1, keepdim=True)) / math.sqrt(dh)
    gc = gs.sum(-1)
    gqt = torch.einsum("bhl,lbi->bhi", gs, x)
    dwk = torch.einsum("bhe,bhi->hei", qh, gqt).reshape(d, d)
    dbk = (qh * gc[..., None]).sum(0).reshape(d)
    gq = (torch.einsum("bhi,hei->bhe", gqt, wk.reshape(H, dh, d))
          + gc[..., None] * bk.reshape(H, dh)).reshape(B, d)
    dwq = gq.T @ x[0]
    dbq = gq.sum(0)
    dx = torch.einsum("bhl,bhi->lbi", gs, qt) \
        + torch.einsum("bhl,bhi->lbi", ad, gxbar)
    dx[0] += gq @ wq
    return (dx, torch.cat([dwq, dwk, dwv]), torch.cat([dbq, dbk, dbv]),
            d_out_w, d_out_b)


@pytest.mark.parametrize("L,B,d,H", FIRST_QUERY_SHAPES)
def test_first_query_kernel_algebra(L, B, d, H):
    """The fused kernels' algebra (``_first_query_plain``: the rearranged
    products; ``_first_query_backward_plain``: the hand-written backward)
    against ``mha_self_attention(...)[0]`` and its autograd gradients in
    float64, with and without dropout from one draw: 1e-12 of the largest
    value (rounding in another order)."""
    x, att = _mha_case(L, B, d, H, torch.float64)
    x.requires_grad_(True)
    params = tuple(att.parameters())
    gy = torch.tensor(np.random.default_rng(d).standard_normal((B, d)))
    for rate in (0.0, 0.2):
        gen = torch.Generator().manual_seed(3)
        ref = tatt.mha_self_attention(att, x, H, rate, gen)[0]
        draw = torch.rand((B, H, L, L), generator=torch.Generator(
            ).manual_seed(3)) if rate else None
        got = _first_query_plain(x, *params, draw, rate, H)
        want = torch.autograd.grad(ref, (x, *params), gy)
        grads = _first_query_backward_plain(
            gy, x.detach(), *(p.detach() for p in params), draw, rate, H)
        for a, b in zip((got, *grads), (ref, *want)):
            a, b = a.detach(), b.detach()
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-12 * float(b.abs().max()))


@pytest.mark.parametrize("head", ["mlp", "attention"])
def test_head_logits_and_gradients_match_jax(head):
    """Logits and the gradient of ``sum(logits * G)`` for every parameter,
    JAX leaves carried across; the attention head without dropout
    (``train=False`` on both sides)."""
    g = _graph()
    params = _jax_params(head, g)
    apply = {"mlp": jheads.apply_mlp_model,
             "attention": jheads.apply_att_model}[head]
    jg = j_build(g)
    cot = np.random.default_rng(1).standard_normal(
        (g.num_nodes, g.num_classes)).astype(np.float32)

    def obj(p):
        return jnp.sum(apply(p, jg.edges, backend="gather") * cot)

    ref_logits = np.asarray(apply(params, jg.edges, backend="gather"))
    ref_grads = _leaves(jax.grad(obj)(params))

    model = _port_model(head, params)
    logits = model(t_build(g, "cpu").edges)
    (logits * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits,
                               rtol=1e-5, atol=1e-6)
    grads = [p.grad.numpy() for p in model.parameters()]
    assert len(grads) == len(ref_grads)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("head", ["mlp", "attention"])
def test_fit_matches_jax(head, no_jax_dropout):
    """5 epochs of ``Trainer.fit`` with the embedding frozen, CE/softmax;
    the attention head with dropout off on both sides."""
    g = _graph(seed=2)
    epochs = 5
    params = _jax_params(head, g, seed=4)
    apply = {"mlp": jheads.apply_mlp_model,
             "attention": jheads.apply_att_model}[head]
    mask = jax.tree_util.tree_map(lambda _: True, params)._replace(
        embedding=False)
    jt = jtrainer.Trainer(None, HL, epochs, EMB, 0.01, 5e-5, backend="gather")
    jloss, act = jlosses.get_loss("SYNTH", sum_model=False)
    jparams, jaccs, jl, _, _ = jt.fit(params, apply, j_build(g), jloss, act,
                                      sum_graph=False, mask=mask,
                                      verbose=False)

    model = _port_model(head, params)
    if head == "attention":
        model.dropout = 0.0
    tt = TTrainer(None, HL, epochs, EMB, 0.01, 5e-5, device="cpu")
    tloss, tact = tlosses.get_loss("SYNTH", sum_model=False)
    model, taccs, tl, _, _ = tt.fit(model, t_build(g, "cpu"), tloss, tact,
                                    sum_graph=False, frozen={"embedding"},
                                    verbose=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(taccs, jaccs, rtol=0,
                               atol=1.0 / len(g.x_val) + 1e-7)
    for (name, t), ref in zip(model.named_parameters(), _leaves(jparams)):
        got = t.detach().numpy()
        if name == "att.in_proj_b":
            # the key bias shifts every score of a softmax row alike, so its
            # gradient is 0 in exact arithmetic and Adam turns each
            # framework's rounding noise into steps of up to lr: held only
            # to that bound
            keys = slice(EMB, 2 * EMB)
            assert np.abs(got[keys]).max() <= epochs * 0.01 * 1.01
            got, ref = np.delete(got, np.r_[keys]), np.delete(ref, np.r_[keys])
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    assert t_count(model, {"embedding"}) == jtrainer.count_trainable_parameters(
        jparams, mask)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same tiny SYNTH dataset (three attribute summaries) loaded by
    both packages."""
    kw = dict(num_entities=400, num_relations=6, num_classes=3,
              avg_degree=4.0, seed=5, labeled_fraction=0.4)
    loaded = []
    for name, synth, mod in (("jax", jsynth, jdataset),
                             ("torch", tsynth, tdataset)):
        d = synth.ensure_synthetic_dataset(
            str(tmp_path_factory.mktemp(name)), **kw)
        loaded.append(mod.Dataset(
            os.path.join(d, "SYNTH_complete.nt"), os.path.join(d, "attr", "sum"),
            os.path.join(d, "attr", "map")).init_dataset(verbose=False))
    return loaded


@pytest.mark.parametrize("trick", ["mlp", "attention"])
def test_transfer_tricks_match_jax_on_mapped_rows(datasets, trick):
    """Concat ``[N, K*d]`` and stack ``[K, N, d]``: each summary's block
    equals the JAX one on the rows that summary maps (the others are
    U[0, 1) draws of each framework's generator)."""
    jd, td = datasets
    rng = np.random.default_rng(9)
    for js, ts in zip(jd.sumGraphs, td.sumGraphs):
        js.embedding = ts.embedding = rng.standard_normal(
            (ts.num_nodes, 6)).astype(np.float32)
    ref = np.asarray(jtransfer.EMBEDDING_TRICKS[trick](
        jd.orgGraph, jd.sumGraphs, 6, jax.random.key(0)))
    got = ttransfer.EMBEDDING_TRICKS[trick](
        td.orgGraph, td.sumGraphs, 6, torch.Generator().manual_seed(0)).numpy()
    n, k = td.orgGraph.num_nodes, len(td.sumGraphs)
    assert k == 3
    assert got.shape == ref.shape == ((n, k * 6) if trick == "mlp" else (k, n, 6))
    blocks = (lambda a: np.split(a, k, axis=1)) if trick == "mlp" else list
    for sg, gb, rb in zip(td.sumGraphs, blocks(got), blocks(ref)):
        hit = np.array([sg.orgNode2sumNode_dict.get(node) in sg.node_to_enum
                        for node in td.orgGraph.nodes])
        assert hit.sum() > 100
        np.testing.assert_array_equal(gb[hit], rb[hit])
        assert ((gb[~hit] >= 0) & (gb[~hit] < 1)).all()


def test_attention_dropout_mean_and_determinism():
    """Dropout keeps each weight with probability 0.8 and scales it by
    1 / 0.8: over many masks the output's mean is the output without
    dropout. One generator seed gives one output; another seed another."""
    rng = np.random.default_rng(11)
    d, heads = 8, 2
    att = tatt.init_mha(torch.Generator().manual_seed(0), d)
    x = torch.tensor(rng.standard_normal((heads, 64, d)).astype(np.float32))
    with torch.no_grad():
        ref = tatt.mha_self_attention(att, x, heads)
        run = lambda gen: tatt.mha_self_attention(att, x, heads, 0.2, gen)
        gen = torch.Generator().manual_seed(5)
        draws = torch.stack([run(gen) for _ in range(2000)])
        a = run(torch.Generator().manual_seed(7))
        b = run(torch.Generator().manual_seed(7))
        c = run(torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ref)
    spread = draws.std(0) / np.sqrt(draws.shape[0])
    assert ((draws.mean(0) - ref).abs() <= 5 * spread + 1e-6).all()


def test_trainer_dropout_is_seeded():
    """Two attention fits from one trainer seed give the same losses;
    another seed gives other losses (the dropout masks differ); models
    without dropout draw nothing from the trainer's generator."""
    g = _graph(seed=6)
    tloss, tact = tlosses.get_loss("SYNTH", sum_model=False)
    dg = t_build(g, "cpu")

    def fit(seed, head="attention"):
        tt = TTrainer(None, HL, 3, EMB, 0.01, 5e-5, seed=seed, device="cpu")
        model = _port_model(head, _jax_params(head, g, seed=6))
        _, _, losses, _, _ = tt.fit(model, dg, tloss, tact, sum_graph=False,
                                    verbose=False)
        return losses, int(torch.randint(0, 2**30, (1,), generator=tt.gen))

    (l1, _), (l2, _), (l3, _) = fit(0), fit(0), fit(1)
    assert l1 == l2 and l1 != l3
    _, after = fit(0, "mlp")
    assert after == int(torch.randint(0, 2**30, (1,),
                                      generator=torch.Generator().manual_seed(0)))


def test_featureless_model_matches_jax():
    """``FeaturelessModel`` (its basis layer on the CPU's plain route)
    against the JAX package's basis ``rgcn_conv`` over ``x = eye(N)``,
    which computes the R-GCN paper's featureless layer 1, ``root[i] + bias
    + sum_r mean_j sum_b comp[r, b] V[b, j]``, then its ordinary basis
    layer 2. JAX's ``init_rgcn_layer`` draws the bases (``[B, N, h]``,
    carried across as the port's ``[N, B, h]``; ``[B, h, C]`` as they are)
    and ``comp``; the biases are drawn non-zero. Logits, the cross-entropy
    loss on the training rows and every leaf's gradient, float32 on both
    sides, at the module's tolerances."""
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
        BasisLayer, RGCNLayer)

    # the JAX ops package exports the function rgcn_conv under the
    # module's name
    jconv = importlib.import_module("scaling_rgcn_training_tpu.ops.rgcn_conv")
    g = _graph(5)
    n, slots, c, bases, hid = (g.num_nodes, g.num_relation_slots,
                               g.num_classes, 5, 6)
    rng = np.random.default_rng(5)
    layers = [jconv.init_rgcn_layer(jax.random.key(i), slots, d_in, d_out,
                                    num_bases=bases)._replace(
        bias=jnp.asarray(rng.standard_normal(d_out).astype(np.float32)))
              for i, (d_in, d_out) in enumerate(((n, hid), (hid, c)))]
    jedges = j_build(g).edges
    eye = jnp.eye(n, dtype=jnp.float32)
    rows, y = g.x_train, g.y_train

    def jloss(l1, l2):
        h = jax.nn.relu(jconv.rgcn_conv(eye, jedges, l1, backend="gather"))
        logits = jconv.rgcn_conv(h, jedges, l2, backend="gather")
        return jlosses.ce_loss(logits[rows], jnp.asarray(y)), logits

    (ref_loss, ref_logits), (g1, g2) = jax.value_and_grad(
        jloss, (0, 1), has_aux=True)(*layers)

    t = lambda a: torch.tensor(np.asarray(a))
    l1, l2 = layers
    model = theads.FeaturelessModel(
        BasisLayer(t(l1.weight).transpose(0, 1).contiguous(), t(l1.comp),
                   t(l1.root), t(l1.bias)),
        RGCNLayer(t(l2.weight), t(l2.root), t(l2.bias), t(l2.comp)))
    tracing.reset()
    logits = model(t_build(g, "cpu").edges)
    assert tracing.counters().get("basis.plain") == 1
    tracing.reset()
    loss = tlosses.ce_loss(logits[torch.as_tensor(rows, dtype=torch.long)],
                           torch.tensor(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), rtol=1e-5, atol=1e-6)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    want = {"rgcn1.bases": np.asarray(g1.weight).transpose(1, 0, 2),
            **{f"rgcn1.{k}": np.asarray(getattr(g1, k))
               for k in ("comp", "root", "bias")},
            **{f"rgcn2.{k}": np.asarray(getattr(g2, k))
               for k in ("weight", "comp", "root", "bias")}}
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, ref in want.items():
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(got[k], ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=k)
