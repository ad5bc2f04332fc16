"""The plain reference: its parts against torch's own modules and a
naive loop, and the port's eager CPU path against it at a tiny AM-shaped
graph, for both configurations."""

import math

import numpy as np
import pytest
import torch

from rgcn_bench import compare, harness, inputs, system
from rgcn_bench.reference import head_attention, rgcn, trunk_dense
from rgcn_bench.tests.tiny import tiny_cell


def _numbers(cell, seed):
    config = cell.config
    inp = inputs.make(cell, seed)
    program = system.build(config, inp, inputs.params(config, inp, "cpu"),
                           "cpu")
    start, replay, state = system.first_steps(program, config,
                                              harness.SETUP_EPOCHS)
    params0 = inputs.params(config, inp, "cpu")
    edges = rgcn.build_edges(*inp.triples, config["num_entities"], "cpu")
    fit = lambda at: rgcn.fit(
        config, edges, inp.labels, params0, 1,
        inputs.dropout_masks(config, inp, "cpu", at.step if at else 0),
        state=at)
    return compare.both(config, (start, fit(None)), (replay, fit(state)),
                        params0, state, inp.labels["y_val"]), state


@pytest.mark.parametrize("name", ["am_baseline_uniform",
                                  "am_attention_uniform"])
def test_port_cpu_path_agrees(name):
    cell = tiny_cell(name)
    values, state = _numbers(cell, 2**32 + 3)
    correct, checks = compare.judge(values, cell.limits)
    assert correct, checks
    assert state.step == 3
    for key in ("loss", "grad", "replay_loss", "replay_grad"):
        assert values[key] < 1e-6, (key, values[key])


def test_conv_matches_a_naive_loop():
    g = torch.Generator().manual_seed(0)
    n, r, t, d_in, d_out = 30, 3, 200, 5, 4
    subj, rel, obj = (torch.randint(0, k, (t,), generator=g).numpy()
                      for k in (n, r, n))
    edges = rgcn.build_edges(subj, rel, obj, n, "cpu")
    x = torch.randn(n, d_in, generator=g, dtype=torch.float64)
    w = torch.randn(2 * r + 1, d_in, d_out, generator=g, dtype=torch.float64)
    root = torch.randn(d_in, d_out, generator=g, dtype=torch.float64)
    bias = torch.randn(d_out, generator=g, dtype=torch.float64)
    edges.norm = edges.norm.double()
    out = trunk_dense.conv(x, w, root, bias, edges, "float32")
    want = x @ root + bias
    triples = list(zip(subj, rel, obj))
    for i in range(n):
        for slot in range(2 * r):
            nbrs = [s if slot % 2 == 0 else o for s, q, o in triples
                    if 2 * q + slot % 2 == slot
                    and (o if slot % 2 == 0 else s) == i]
            if nbrs:
                want[i] += x[nbrs].mean(0) @ w[slot]
    assert torch.allclose(out, want, atol=1e-12)


def test_attention_front_matches_torch_mha():
    config = {"num_sums": 3, "num_entities": 17, "emb_dim": 63,
              "attention_heads": 3, "dropout": 0.2, "num_relations": 2,
              "hidden": 16, "num_classes": 11}
    params = head_attention.init_params(
        config, torch.Generator().manual_seed(1), "cpu")
    params["att.in_proj_b"].normal_()
    params["att.out_proj_b"].normal_()
    mha = torch.nn.MultiheadAttention(63, 3, dropout=0.2)
    with torch.no_grad():
        mha.in_proj_weight.copy_(params["att.in_proj_w"])
        mha.in_proj_bias.copy_(params["att.in_proj_b"])
        mha.out_proj.weight.copy_(params["att.out_proj_w"])
        mha.out_proj.bias.copy_(params["att.out_proj_b"])
    mha.eval()
    x = params["embedding"]
    want = mha(x, x, x, need_weights=False)[0][0]
    got = head_attention.front(params, config, "float32")
    assert torch.allclose(got, want, atol=1e-5)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(2)
    p0 = torch.randn(50, generator=g)
    grads = [torch.randn(50, generator=g) for _ in range(3)]
    p = p0.clone().requires_grad_()
    opt = torch.optim.Adam([p], lr=0.01, weight_decay=5e-5)
    for gr in grads:
        p.grad = gr.clone()
        opt.step()
    config = {"adam_betas": (0.9, 0.999), "lr": 0.01, "weight_decay": 5e-5,
              "adam_eps": 1e-8}
    q, m, v = p0.clone(), torch.zeros(50), torch.zeros(50)
    for step, gr in enumerate(grads, 1):
        gr = gr + 5e-5 * q
        m = 0.9 * m + 0.1 * gr
        v = 0.999 * v + 0.001 * gr * gr
        q = q - 0.01 * (m / (1 - 0.9 ** step)) / (
            (v / (1 - 0.999 ** step)).sqrt() + 1e-8)
    assert torch.allclose(p.detach(), q, atol=1e-7)


def test_metrics_by_hand():
    pred = np.array([0, 1, 1, 2])
    classes = np.array([0, 1, 2, 2])
    acc, f1_w, f1_m = rgcn.metrics(pred, classes, 4)
    assert acc == 0.75
    f1 = np.array([1.0, 2 / 3, 2 / 3, 0.0])
    assert math.isclose(f1_m, f1.mean())
    assert math.isclose(f1_w, (f1 * [1, 1, 2, 0]).sum() / 4)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-10)])
    r = rgcn._round_tf32(x)
    assert r.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10)]
