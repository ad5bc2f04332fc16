"""The benchmark's readers of the program's recorder
(``rgcn_bench/metrics/``: the step's device stamps, the fit's and the
plan's spans, the plan's counter) on a recorder filled by tiny CPU fits
through the stand-in graph of ``test_torch_port_step_graph.py``: each
reading finite, and in every replayed epoch the conv, head and optimizer
durations the medians are taken of add up exactly to the epoch's stamped
``step.start`` to ``step.end``. A program without the recorder, or one
that recorded nothing, gives no reading and raises nothing."""

import math
import statistics

import numpy as np
import pytest

from rgcn_bench import program_trace, spec
from scaling_rgcn_training_tpu_torch.train import losses as tlosses
from scaling_rgcn_training_tpu_torch.utils import tracing
from tests.test_torch_port_step_graph import _frozen, _setup

READERS = ("conv_span_ms", "head_span_ms", "adam_span_ms",
           "between_steps_ms", "fit_start_ms", "first_step_s", "plan_sort_s",
           "plan_max_row_edges")


def _read(name):
    return spec.metric_reader(name).read(None)


@pytest.fixture(scope="module")
def filled():
    """Three stand-in fits (summation, attention, summation) of 6 epochs
    over one plan; the recorder's state and each reader's value."""
    mp = pytest.MonkeyPatch()
    from scaling_rgcn_training_tpu_torch.train import step_graph as sg
    from scaling_rgcn_training_tpu_torch.train import trainer as trainer_mod
    from tests.test_torch_port_step_graph import StandInGraph

    mp.setattr(trainer_mod, "step_route", lambda devices: "graph")
    mp.setattr(trainer_mod, "CudaStepGraph", StandInGraph)
    mp.setattr(sg, "CudaStepGraph", StandInGraph)
    tracing.reset()
    loss_fn, act = tlosses.get_loss("SYNTH", sum_model=False)
    try:
        for head in ("summation", "attention", "summation"):
            trainer, model, graph = _setup("fused", head, 6)
            trainer.fit(model, graph, loss_fn, act, sum_graph=False,
                        frozen=_frozen(head), verbose=False)
        state = {"epochs": tracing.epochs(), "fits": tracing.fits(),
                 "spans": tracing.spans(), "counters": tracing.counters(),
                 "graph": graph}
        state["values"] = {name: _read(name) for name in READERS}
    finally:
        mp.undo()
        tracing.reset()
    return state


def test_every_reader_is_in_the_benchmark():
    per_layer = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in READERS:
        assert "workloads" not in per_layer[name]
        assert callable(spec.metric_reader(name).read)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_finite_on_tiny_fits(name, filled):
    value = filled["values"][name]
    assert value is not None and math.isfinite(value) and value > 0


def test_layers_add_up_to_the_stamped_step(filled):
    replays = [e for e in filled["epochs"] if e["kind"] == "replay"]
    assert len(replays) == 3 * 4
    for fit in filled["fits"]:
        slots = fit["slots"]
        assert (slots[0], slots[-1]) == ("step.start", "step.end")
    for e in replays:
        assert e["conv_ns"] + e["head_ns"] + e["adam_ns"] == \
            e["stamps"][-1] - e["stamps"][0]
    med = lambda key: statistics.median(e[key] for e in replays) / 1e6
    values = filled["values"]
    assert values["conv_span_ms"] == med("conv_ns")
    assert values["head_span_ms"] == med("head_ns")
    assert values["adam_span_ms"] == med("adam_ns")


def test_between_steps_and_fit_start_read_their_records(filled):
    by_fit = {}
    for e in filled["epochs"]:
        by_fit.setdefault(e["fit"], []).append(e)
    gaps = [b["start_ns"] - a["end_ns"] for epochs in by_fit.values()
            for a, b in zip(epochs, epochs[1:])
            if a["kind"] == b["kind"] == "replay"]
    assert len(gaps) == 3 * 3
    assert filled["values"]["between_steps_ms"] == \
        statistics.median(gaps) / 1e6
    starts = []
    for fit in filled["fits"][1:]:
        own = [r for r in filled["spans"] if r["fit"] == fit["fit"]
               and r["name"] in tracing.FIT_START]
        warm = [e for e in filled["epochs"] if e["fit"] == fit["fit"]
                and e["kind"] == "warmup"]
        starts.append(sum(r["end_ns"] - r["start_ns"] for r in own)
                      - sum(e["end_ns"] - e["start_ns"] for e in warm))
        assert [r["name"] for r in own].count("fit.warmup") == len(warm) == 2
    assert filled["values"]["fit_start_ms"] == statistics.median(starts) / 1e6


def test_plan_and_first_step_readers(filled):
    spans = filled["spans"]
    first = next(r for r in spans if r["name"] == "fit.warmup")
    assert filled["values"]["first_step_s"] == \
        (first["end_ns"] - first["start_ns"]) / 1e9
    sorts = [r for r in spans if r["name"] in ("plan.norm", "plan.sort")]
    assert len(sorts) == 2 * 3
    assert filled["values"]["plan_sort_s"] == pytest.approx(
        sum(r["end_ns"] - r["start_ns"] for r in sorts) / 1e9, rel=1e-12)
    edges = filled["graph"].edges
    rows = [np.diff(edges.dst_rowptr.numpy()).max(),
            np.diff(edges.src_rowptr.numpy()).max()]
    assert filled["values"]["plan_max_row_edges"] == max(rows)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_nothing_on_an_empty_recorder(name):
    tracing.reset()
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_nothing_without_the_recorder(name, monkeypatch):
    """An older program: ``utils/tracing.py`` without the recorder."""
    monkeypatch.delattr(tracing, "replay_layers")
    assert program_trace.recorder() is None
    tracing.count("plan.max_row_edges", 3, add=False)
    try:
        assert _read(name) is None
    finally:
        tracing.reset()
