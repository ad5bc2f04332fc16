"""The step's device stamps on the card (``csrc/step_marks.cu``
``step_mark_kernel`` through ``utils/tracing.py`` ``mark``): inside a
``StepGraph``'s warm-ups, its capture and every replay, and in
``Trainer.fit``; and the clock offset of one fit.

Needs a CUDA device and nvcc; skips without a card. Imports no jax:

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_step_marks_cuda.py -q
"""

import time

import numpy as np
import pytest
import torch

SLOTS = ["step.start", "trunk.in", "trunk.out", "trunk.in", "trunk.out",
         "loss", "trunk.grad", "backward", "optimizer", "step.end"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_cuda_step_marks_in_warmups_and_replays():
    """A step of two matmuls with a mark between them, 6 steps on the
    graph route: every row stamped (the capture stamps nothing, each
    replay its own row), non-decreasing along a row and from row to row,
    and the marks counted in no wrapper's ``LAUNCHES``."""
    _card()
    from scaling_rgcn_training_tpu_torch.ops import cuda_build
    from scaling_rgcn_training_tpu_torch.train.step_graph import (
        WARMUP, CudaStepGraph, StepGraph)
    from scaling_rgcn_training_tpu_torch.utils import tracing

    a = torch.randn(1024, 1024, device="cuda")

    def step():
        b = a @ a
        tracing.mark("half")
        return ((b @ a).sum(),)

    before = dict(cuda_build.LAUNCHES)
    with StepGraph(step, 6, 1, "cuda", CudaStepGraph("cuda")) as loop:
        for _ in range(6):
            loop.run()
        loop.rows(0, 6)
        rows = loop.stamp_rows()
        kinds = list(loop.kinds)
    assert loop.marks.names == ["step.start", "half", "step.end"]
    assert kinds == ["warmup"] * WARMUP + ["replay"] * (6 - WARMUP)
    flat = [t for row in rows for t in row]
    assert all(flat) and flat == sorted(flat)
    # a 1024^3 product takes some microseconds: the mark after it is later
    assert all(row[1] - row[0] > 1000 for row in rows)
    assert cuda_build.LAUNCHES == before


def _fit(head, frozen, route, monkeypatch):
    from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph
    from scaling_rgcn_training_tpu_torch.models.heads import HEADS
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
    from scaling_rgcn_training_tpu_torch.train.losses import ce_loss
    from scaling_rgcn_training_tpu_torch.train.step_graph import EAGER_ENV
    from scaling_rgcn_training_tpu_torch.train.trainer import Trainer
    from scaling_rgcn_training_tpu_torch.utils import tracing

    if route == "eager":
        monkeypatch.setenv(EAGER_ENV, "1")
    else:
        monkeypatch.delenv(EAGER_ENV, raising=False)
    rng = np.random.default_rng(1)
    n, e, slots, emb, hl, c = 4000, 30000, 9, 16, 8, 4
    src, dst, rel = (rng.integers(0, m, e) for m in (n, n, slots))
    labelled = rng.choice(n, 600, replace=False)
    onehot = torch.eye(c)[torch.as_tensor(np.arange(600) % c)]
    t = lambda x: torch.as_tensor(x).to("cuda")
    graph = DeviceGraph(
        edges=build_rel_edges(src, dst, rel, n, slots, device="cuda"),
        x_train=t(labelled[:400]), y_train=t(onehot[:400]),
        x_val=t(labelled[400:]), y_val=t(onehot[400:]))
    trainer = Trainer(None, hl, 8, emb, lr=0.01, weight_d=5e-5, seed=0,
                      device="cuda")
    model = HEADS[head](trainer.gen, slots, hl, c, n, emb, num_sums=2,
                        device="cuda")
    _, _, losses, _, _ = trainer.fit(model, graph, ce_loss, "softmax",
                                     sum_graph=False, frozen=frozen,
                                     verbose=False)
    fit = tracing.fits()[-1]
    return losses, fit, [r for r in tracing.epochs() if r["fit"] == fit["fit"]]


@pytest.mark.cuda
@pytest.mark.parametrize("head,frozen", [("summation", ()),
                                         ("attention", ("embedding",)),
                                         ("summation", ("embedding",))])
def test_cuda_fit_stamps_every_epoch(head, frozen, monkeypatch):
    """``Trainer.fit`` on the card, graph and eager routes: the same
    losses, one stamped row an epoch in the step's slot order, stamps
    non-decreasing, the layers adding up to the step; a frozen trunk
    input leaves ``trunk.grad`` 0; a clock offset whose uncertainty is
    under a millisecond."""
    _card()
    grad = SLOTS.index("trunk.grad")
    runs = {route: _fit(head, frozen, route, monkeypatch)
            for route in ("eager", "graph")}
    assert runs["eager"][0] == runs["graph"][0]
    for route, (losses, fit, epochs) in runs.items():
        assert fit["slots"] == SLOTS
        assert 0 <= fit["clock_uncertainty_ns"] < 1_000_000
        assert len(epochs) == 8
        for e in epochs:
            assert (e["stamps"][grad] == 0) == (frozen == ("embedding",)
                                                and head == "summation")
            reached = [t for t in e["stamps"] if t]
            assert reached == sorted(reached)
            assert e["conv_ns"] + e["head_ns"] + e["adam_ns"] == \
                e["end_ns"] - e["start_ns"] > 0
    kinds = [e["kind"] for e in runs["graph"][2]]
    assert kinds.count("replay") == 6 and set(kinds) == {"warmup", "replay"}


@pytest.mark.cuda
def test_cuda_clock_offset_maps_a_stamp_into_its_host_interval():
    """A mark between two host reads around a synchronise, moved to the
    host clock by the fit's offset, lies between them (within twice the
    offset's uncertainty)."""
    _card()
    from scaling_rgcn_training_tpu_torch.utils import tracing

    offset, err = tracing.clock_offset("cuda")
    stamps = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    cursor = torch.zeros(1, dtype=torch.int64, device="cuda")
    time.sleep(0.01)
    torch.cuda.synchronize()
    lo = time.perf_counter_ns()
    tracing._stamp(stamps, cursor, 0)
    torch.cuda.synchronize()
    hi = time.perf_counter_ns()
    host = int(stamps.item()) - offset
    assert lo - 2 * err - 50_000 <= host <= hi + 2 * err + 50_000
