"""Port trainer, losses, metrics and transfer against the JAX package.

The JAX ``init_emb_model`` parameters are carried into the port with
``emb_model_from_numpy``; both ``Trainer.fit``s then run 5 epochs on the
same graph (JAX on the CPU, the port with its plain span versions).
Tolerances: loss series rtol 1e-4; each validation accuracy within one
validation row (1 / |x_val|); final parameters rtol 1e-4 with atol 1e-6
(Adam's update is lr * m / (sqrt(v) + eps) in both, summed in another
order).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.graphs.device import build_device_graph as j_build
from scaling_rgcn_training_tpu.models import heads as jheads
from scaling_rgcn_training_tpu.train import losses as jlosses
from scaling_rgcn_training_tpu.train import metrics as jmetrics
from scaling_rgcn_training_tpu.train.trainer import (
    Trainer as JTrainer, count_trainable_parameters as j_count)
from scaling_rgcn_training_tpu_torch.graphs.device import build_device_graph as t_build
from scaling_rgcn_training_tpu_torch.models.heads import emb_model_from_numpy
from scaling_rgcn_training_tpu_torch.train import losses as tlosses
from scaling_rgcn_training_tpu_torch.train import metrics as tmetrics
from scaling_rgcn_training_tpu_torch.train.trainer import (
    Trainer as TTrainer, count_trainable_parameters as t_count)


def _graph(seed=0, n=200, e=1500, r=3, c=4, multi_label=False):
    rng = np.random.default_rng(seed)
    labelled = rng.choice(n, 90, replace=False)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, 90)]
    if multi_label:
        y = np.maximum(y, (rng.random((90, c)) < 0.3).astype(np.float32))
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


@pytest.mark.parametrize("dataset,freeze", [("AIFB", False), ("SYNTH", True)])
def test_fit_matches_jax(dataset, freeze):
    """BCE/sigmoid (AIFB) and CE/softmax (other datasets, here with the
    embedding frozen)."""
    g = _graph(multi_label=dataset == "AIFB")
    emb, hl, epochs = 12, 8, 5
    params = jheads.init_emb_model(jax.random.key(3), g.num_relation_slots,
                                   hl, g.num_classes, g.num_nodes, emb)
    mask = None
    if freeze:
        mask = jax.tree_util.tree_map(lambda _: True, params)._replace(
            embedding=False)
    jt = JTrainer(None, hl, epochs, emb, 0.01, 5e-5, backend="gather")
    jloss, act = jlosses.get_loss(dataset, sum_model=False)
    jparams, jaccs, jl, jf1w, jf1m = jt.fit(
        params, jheads.apply_emb_model, j_build(g), jloss, act,
        sum_graph=False, mask=mask, verbose=False)

    model = emb_model_from_numpy(np.asarray(params.embedding),
                                 list(params.rgcn1), list(params.rgcn2))
    tt = TTrainer(None, hl, epochs, emb, 0.01, 5e-5, device="cpu")
    tloss, tact = tlosses.get_loss(dataset, sum_model=False)
    model, taccs, tl, tf1w, tf1m = tt.fit(
        model, t_build(g, "cpu"), tloss, tact, sum_graph=False,
        frozen={"embedding"} if freeze else (), verbose=False)

    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert len(taccs) == len(jaccs) == epochs
    np.testing.assert_allclose(taccs, jaccs, rtol=0, atol=1.0 / len(g.x_val) + 1e-7)
    got = [model.embedding, *model.rgcn1.parameters(), *model.rgcn2.parameters()]
    for t, ref in zip(got, _leaves(jparams)):
        np.testing.assert_allclose(t.detach().numpy(), ref, rtol=1e-4, atol=1e-6)
    if freeze:
        np.testing.assert_array_equal(model.embedding.detach().numpy(),
                                      np.asarray(params.embedding))
    frozen = {"embedding"} if freeze else set()
    assert t_count(model, frozen) == j_count(
        jparams, mask if mask is not None
        else jax.tree_util.tree_map(lambda _: True, jparams))


@pytest.mark.parametrize("activation", ["sigmoid", "softmax"])
def test_metrics_match_jax(activation):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((40, 5)).astype(np.float32)
    logits[:3] = 0.0               # sigmoid 0.5 rounds half to even -> 0
    y = (rng.random((40, 5)) > 0.6).astype(np.float32)
    x = rng.choice(40, 25, replace=False)
    ref = jmetrics.evaluate(jnp.asarray(logits), jnp.asarray(x),
                            jnp.asarray(y[x]), activation)
    got = tmetrics.evaluate(torch.tensor(logits), torch.tensor(x),
                            torch.tensor(y[x]), activation)
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in ref], rtol=1e-6)
    np.testing.assert_array_equal(
        tmetrics.predictions(torch.tensor(logits), activation).numpy(),
        np.asarray(jmetrics.predictions(jnp.asarray(logits), activation)))


@pytest.mark.parametrize("dataset,sum_model", [("AIFB", False), ("MUTAG", True),
                                               ("AM", False)])
def test_losses_match_jax(dataset, sum_model):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((30, 4)).astype(np.float32)
    y = rng.random((30, 4)).astype(np.float32)
    jfn, jact = jlosses.get_loss(dataset, sum_model)
    tfn, tact = tlosses.get_loss(dataset, sum_model)
    assert tact == jact
    np.testing.assert_allclose(
        float(tfn(torch.tensor(logits), torch.tensor(y))),
        float(jfn(jnp.asarray(logits), jnp.asarray(y))), rtol=1e-5)


def test_classification_table_lists_every_class():
    pred = torch.tensor([[1, 0, 0], [0, 1, 0], [1, 0, 0]], dtype=torch.int32)
    y = torch.tensor([[1, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=torch.float32)
    table = tmetrics.classification_table(pred, y).splitlines()
    assert len(table) == 1 + 3 + 2
    assert table[1].split() == ["0", "1.00", "1.00", "1.00", "2"]
    assert table[3].split() == ["2", "0.00", "0.00", "0.00", "1"]
