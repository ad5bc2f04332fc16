"""The program's recorder (``utils/tracing.py``) on the CPU.

- ``span``: nesting, parent ids, fit ids, the bound on fits kept, and the
  span as a ``torch.profiler`` event inside its own host interval;
  ``count``; ``kernel.build`` and ``kernel_builds`` around a build (a
  stand-in ``nvcc`` that writes its output).
- The step's marks in ``Trainer.fit`` on the eager route and through the
  stand-in graph of ``test_torch_port_step_graph.py``, summation and
  attention heads: one stamp row per epoch, the slots in the order the
  step marks them, non-decreasing stamps, the losses of the loop the step
  function replaced bit for bit; a frozen trunk input's ``trunk.grad``
  slot holds 0; a later step that marks another sequence raises.
- The plan's spans and ``plan.max_row_edges`` (the bincounts' largest
  row) on a build and on a plan-cache hit.
- ``idle_gaps`` on a written Chrome trace: the largest gaps, the span the
  host was in, the marks around a gap inside a step.
"""

import os
import stat
import time

import numpy as np
import pytest
import torch

from scaling_rgcn_training_tpu_torch.graphs.device import build_device_graph
from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
from scaling_rgcn_training_tpu_torch.train import losses as tlosses
from scaling_rgcn_training_tpu_torch.train import step_graph as sg
from scaling_rgcn_training_tpu_torch.utils import tracing
from tests.test_torch_port_step_graph import (
    _frozen, _parent_fit, _setup, graph_route)  # noqa: F401

SLOTS = ["step.start", "trunk.in", "trunk.out", "trunk.in", "trunk.out",
         "loss", "trunk.grad", "backward", "optimizer", "step.end"]


@pytest.fixture
def recorder():
    tracing.reset()
    yield tracing
    tracing.reset()


def _by_name(records):
    return {r["name"]: r for r in records}


def test_span_nesting_and_parent_ids(recorder):
    with tracing.span("outer"):
        with tracing.span("inner", what=1):
            pass
        with tracing.span("sibling"):
            pass
    with tracing.fit_span() as fit:
        with tracing.span("fit.step"):
            pass
    got = _by_name(tracing.spans())
    assert got["outer"]["parent"] is None
    assert got["inner"]["parent"] == got["sibling"]["parent"] == \
        got["outer"]["id"]
    assert got["inner"]["args"] == {"what": 1}
    assert got["outer"]["start_ns"] <= got["inner"]["start_ns"] <= \
        got["inner"]["end_ns"] <= got["sibling"]["start_ns"] <= \
        got["outer"]["end_ns"]
    assert {got[n]["fit"] for n in ("outer", "inner", "sibling")} == {None}
    assert got["fit.step"]["fit"] == got["fit"]["fit"] == fit
    assert got["fit.step"]["parent"] == got["fit"]["id"]
    assert [f["fit"] for f in tracing.fits()] == [fit]


def test_recorder_keeps_the_last_fits():
    rec = tracing.Recorder(fits=3)
    for _ in range(5):
        with rec.fit_span():
            with rec.span("fit.step"):
                pass
    with rec.span("plan"):
        pass
    assert [f["fit"] for f in rec.fits()] == [2, 3, 4]
    assert sorted({r["fit"] for r in rec.spans()}, key=str) == [2, 3, 4, None]
    assert len(rec.spans(3)) == 2 and [r["name"] for r in rec.spans(None)] \
        == ["plan"]
    rec.reset()
    assert rec.spans() == [] and rec.fits() == [] and rec.counters() == {}


def test_count_adds_and_sets(recorder):
    tracing.count("kernel_builds")
    tracing.count("kernel_builds", 2)
    tracing.count("plan.max_row_edges", 7, add=False)
    tracing.count("plan.max_row_edges", 5, add=False)
    assert tracing.counters() == {"kernel_builds": 3,
                                  "plan.max_row_edges": 5}


def test_span_lies_in_a_cpu_profiler_trace_inside_its_interval(recorder):
    """The span's ``annotate`` event in ``torch.profiler``'s own clock
    (Unix time) lies inside the span's host interval, mapped from
    ``perf_counter_ns`` by one offset read beside it; a later span does
    not hold it."""
    wall = time.time_ns() - time.perf_counter_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("fit.step"):
            time.sleep(0.05)
            torch.ones(8) + 1
        with tracing.span("fit.callback"):
            time.sleep(0.05)
    base = prof.profiler.kineto_results.trace_start_ns()
    events = [e for e in prof.events() if e.name == "fit.step"]
    assert len(events) == 1
    lo = base + events[0].time_range.start * 1e3
    hi = base + events[0].time_range.end * 1e3
    got = _by_name(tracing.spans())
    slack = 2e6       # the two clocks' conversion, not the span's length
    assert got["fit.step"]["start_ns"] + wall - slack <= lo < hi <= \
        got["fit.step"]["end_ns"] + wall + slack
    assert hi < got["fit.callback"]["start_ns"] + wall + slack <= \
        got["fit.callback"]["end_ns"] + wall - 40e6


def test_kernel_build_span_and_counter(recorder, tmp_path, monkeypatch):
    """A build of a missing library lies in one ``kernel.build`` span naming
    its source and adds to ``kernel_builds``; a built one builds nothing
    (a stand-in ``nvcc`` writes the ``-o`` file)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    paths = cuda_build.build(["step_marks"])
    assert os.path.exists(paths["step_marks"])
    cuda_build.build(["step_marks"])
    builds = [r for r in tracing.spans() if r["name"] == "kernel.build"]
    assert len(builds) == 1
    assert builds[0]["args"]["sources"] == ["step_marks"]
    assert tracing.counters()["kernel_builds"] == 1


def _fit(route, head, frozen=None, epochs=6, verbose=False):
    """One fit on the CPU by ``route`` (``"eager"`` or ``"graph"``, the
    stand-in); returns its losses and its fit id."""
    loss_fn, act = tlosses.get_loss("SYNTH", sum_model=False)
    trainer, model, graph = _setup("fused", head, epochs)
    assert trainer.step_route() == route
    _, _, losses, _, _ = trainer.fit(
        model, graph, loss_fn, act, sum_graph=False,
        frozen=_frozen(head) if frozen is None else frozen, verbose=verbose)
    return losses, tracing.fits()[-1]["fit"]


def _parent_losses(head, frozen=None, epochs=6):
    loss_fn, act = tlosses.get_loss("SYNTH", sum_model=False)
    trainer, model, graph = _setup("fused", head, epochs)
    return _parent_fit(trainer, model, graph, loss_fn, act,
                       _frozen(head) if frozen is None else frozen)[0]


@pytest.fixture(params=["eager", "graph"])
def route(request, monkeypatch):
    if request.param == "graph":
        request.getfixturevalue("graph_route")
    return request.param


@pytest.mark.parametrize("head", ["summation", "attention"])
def test_fit_stamps_every_epoch_in_slot_order(head, route, recorder):
    losses, fit = _fit(route, head)
    assert losses == _parent_losses(head)
    record = tracing.fits()[-1]
    assert record["slots"] == SLOTS
    assert (record["clock_offset_ns"], record["clock_uncertainty_ns"]) == \
        (0, 0)
    epochs = [e for e in tracing.epochs() if e["fit"] == fit]
    assert [e["epoch"] for e in epochs] == list(range(6))
    want = ["eager"] * 6 if route == "eager" else \
        ["warmup"] * sg.WARMUP + ["replay"] * (6 - sg.WARMUP)
    assert [e["kind"] for e in epochs] == want
    for e in epochs:
        assert len(e["stamps"]) == len(SLOTS) and all(e["stamps"])
        assert e["stamps"] == sorted(e["stamps"])
        assert e["conv_ns"] + e["head_ns"] + e["adam_ns"] == \
            e["stamps"][-1] - e["stamps"][0] == e["end_ns"] - e["start_ns"]
        assert e["conv_ns"] > 0 and e["head_ns"] > 0 and e["adam_ns"] > 0
    names = [r["name"] for r in tracing.spans(fit)]
    assert names.count("fit.callback") == 0
    assert names.count("fit.readback") == names.count("fit.prepare") == 1
    if route == "graph":
        assert names.count("fit.warmup") == sg.WARMUP
        assert names.count("fit.capture") == names.count("fit.close") == 1
        assert names.count("fit.step") == 6 - sg.WARMUP
        assert tracing.fit_start_ns(fit) > 0
    else:
        assert names.count("fit.step") == 6


def test_frozen_trunk_input_leaves_its_grad_slot_zero(route, recorder):
    """The summation head with its embedding frozen: the trunk's input
    needs no grad, so ``trunk.grad`` keeps its slot, unwritten, and its
    interval merges into the next (heads)."""
    frozen = ("embedding",)
    losses, fit = _fit(route, "summation", frozen=frozen)
    assert losses == _parent_losses("summation", frozen=frozen)
    assert tracing.fits()[-1]["slots"] == SLOTS
    grad = SLOTS.index("trunk.grad")
    for e in (e for e in tracing.epochs() if e["fit"] == fit):
        assert e["stamps"][grad] == 0
        reached = [t for t in e["stamps"] if t]
        assert len(reached) == len(SLOTS) - 1 and reached == sorted(reached)
        assert e["conv_ns"] + e["head_ns"] + e["adam_ns"] == \
            e["end_ns"] - e["start_ns"]


def test_verbose_fit_prints_its_step_spans(graph_route, recorder, capsys):
    _, fit = _fit("graph", "summation", verbose=True)
    out = capsys.readouterr().out
    line = tracing.fit_line(fit)
    assert line.startswith(f"step spans over {6 - sg.WARMUP} replays")
    assert line in out.splitlines()


def test_marks_outside_a_step_do_nothing_and_a_changed_sequence_raises(
        recorder):
    tracing.mark("loose")
    x = torch.ones(3, requires_grad=True)
    assert tracing.grad_mark(x, "trunk.grad") is x
    flip = iter([True, False])

    def step():
        tracing.mark("a" if next(flip) else "b")
        return (torch.zeros(()),)

    loop = sg.StepGraph(step, 2, 1, "cpu")
    loop.run()
    assert loop.marks.names == ["step.start", "a", "step.end"]
    with pytest.raises(RuntimeError, match="slot 1"):
        loop.run()


def _graph(seed=3, n=300, e=2500, slots=5):
    rng = np.random.default_rng(seed)
    g = Graph("SYNTH")
    g.num_nodes, g.num_edges = n, e
    g.relations = {f"r{i}": i for i in range(slots)}
    g.edge_src = rng.integers(0, n, e).astype(np.int32)
    # a hub: a tenth of the edges into node 7
    g.edge_dst = np.where(rng.random(e) < 0.1, 7,
                          rng.integers(0, n, e)).astype(np.int32)
    g.edge_type = rng.integers(0, slots, e).astype(np.int32)
    return g


@pytest.mark.parametrize("cached", [False, True])
def test_plan_spans_and_max_row_edges(cached, recorder, tmp_path):
    g = _graph()
    want = max(np.bincount(g.edge_dst).max(), np.bincount(g.edge_src).max())
    cache = str(tmp_path) if cached else None
    if cached:
        build_rel_edges(g.edge_src, g.edge_dst, g.edge_type, g.num_nodes,
                        g.num_relation_slots, cache_dir=cache)
        tracing.reset()
    edges = build_rel_edges(g.edge_src, g.edge_dst, g.edge_type, g.num_nodes,
                            g.num_relation_slots, cache_dir=cache)
    assert edges.num_edges == g.num_edges
    assert tracing.counters()["plan.max_row_edges"] == want > 200
    names = [r["name"] for r in tracing.spans()]
    if cached:     # loaded: no norm, no sorts
        assert names == ["plan.cache", "plan.place"]
    else:
        assert names == ["plan.norm", "plan.sort", "plan.place"]


def test_device_graph_runs_in_the_plan_span(recorder, tmp_path):
    g = _graph()
    g.x_train, g.y_train = np.arange(10), np.eye(3)[np.arange(10) % 3]
    build_device_graph(g, "cpu", plan_cache=str(tmp_path))
    got = tracing.spans()
    plan = next(r for r in got if r["name"] == "plan")
    inner = {r["name"] for r in got if r["parent"] == plan["id"]}
    assert inner == {"plan.norm", "plan.sort", "plan.cache", "plan.place"}
    assert all(plan["start_ns"] <= r["start_ns"] <= r["end_ns"] <=
               plan["end_ns"] for r in got)


def test_clock_offset_off_the_card_is_zero():
    assert tracing.clock_offset("cpu") == (0, 0)


def test_idle_gaps_name_the_span_and_the_marks(tmp_path):
    """A written Chrome trace of two 3-mark steps: the largest gaps, the
    host span at each one's middle, and the marks around a gap inside a
    step (None between steps)."""
    mark = "void (anonymous namespace)::step_mark_kernel(long const*, long*)"
    kernel = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name,
                                    "ts": ts, "dur": dur,
                                    "args": {"device": 0, "stream": 7}}
    host = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation",
                                  "name": name, "ts": ts, "dur": dur}
    events = [kernel(mark, 0, 1), kernel("conv", 1, 9), kernel(mark, 10, 1),
              # a 30 us gap inside the first step
              kernel("adam", 41, 9), kernel(mark, 50, 1),
              # a 100 us gap between the steps
              kernel(mark, 151, 1), kernel("conv", 152, 8),
              kernel(mark, 165, 1), kernel(mark, 166, 1),
              host("fit.step", 0, 45), host("fit", -5, 500),
              host("fit.callback", 60, 80)]
    path = tmp_path / "trace.json"
    path.write_text(__import__("json").dumps({"traceEvents": events}))
    gaps = tracing.idle_gaps(str(path), ["step.start", "loss", "step.end"],
                             top=3)
    assert [(g["start"], g["ms"]) for g in gaps] == \
        [(51.0, 0.1), (11.0, 0.03), (160.0, 0.005)]
    assert [g["span"] for g in gaps] == ["fit.callback", "fit.step", "fit"]
    assert [g["marks"] for g in gaps] == [None, ("loss", "step.end"),
                                          ("step.start", "loss")]
