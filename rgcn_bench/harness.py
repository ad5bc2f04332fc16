"""One run of one cell: set-up, the measured window, the traced stretch and
the comparison with the reference.

- Set-up (``setup_s``, from the process's start to the window's): the
  inputs from the seed, the program's graph plan and model, and one short
  fit of ``SETUP_EPOCHS`` epochs through the window's own call (two eager
  warm-ups, the capture, replays), whose first step and second replay the
  comparison reads. The same trainer, graph and model go on into the
  window.
- The window: fine-tunes of the configuration's epochs back to back
  through ``Trainer.fit``, each with its warm-ups and capture, until
  ``seconds`` have passed; a fit still running then is cut at an epoch.
  Each epoch ends at a CUDA event recorded by the harness's ``on_epoch``;
  the host waits for the event ``DEPTH`` epochs back, so it stays that
  far ahead of the card and sees the clock. Epochs that ended within
  ``seconds`` of the window's start count. The reserved peak is read when
  the window's first fit ends (what one fine-tune needs, with the set-up
  fit before it): the peak grows with the fits a process has run, so a
  read at the close would grow with the step's speed.
- With ``trace``: ``torch.profiler`` over ``TRACE_EPOCHS`` replayed
  epochs of the first fit (after ``TRACE_SKIP``), the card synchronised
  at both ends.
- After the window: the peaks read, the program freed, then the
  reference run from the same inputs (the first step) and from the
  program's state before the judged replay, and the eight numbers judged
  (``compare.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rgcn_bench import compare, cost, inputs, spec, system, trace
from rgcn_bench.reference import rgcn

SETUP_EPOCHS = 4
DEPTH = 3
TRACE_SKIP = 4
TRACE_EPOCHS = 10


class WindowClosed(Exception):
    """Raised from ``on_epoch`` to end the fit that runs past the window."""


class Marks:
    """Epoch ends on the card's clock (CUDA events), or the host's on the
    CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[Any] = []
        self.start = self._mark()

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def record(self) -> None:
        self.marks.append(self._mark())

    def done(self, i: int) -> bool:
        return not self.cuda or self.marks[i].query()

    def wait(self, i: int) -> None:
        if self.cuda:
            self.marks[i].synchronize()

    def elapsed_ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [self.start.elapsed_time(m) for m in self.marks]
        return [(m - self.start) * 1e3 for m in self.marks]


@dataclasses.dataclass
class Window:
    t0: float                      # the window's start, perf_counter
    epoch_ms: List[float]          # each counted epoch's interval
    issue_ms: List[float]          # the program's host ms an epoch, queue ahead
    losses: List[float]            # every finished fit's losses
    stretch: Optional[trace.Stretch]
    reserved: int                  # peak bytes reserved by the first fit's end


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reserved(device: torch.device) -> int:
    return torch.cuda.max_memory_reserved(device) \
        if device.type == "cuda" else 0


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_window(program: system.Program, config: Dict[str, Any],
               seconds: float, device: torch.device,
               traced: bool) -> Window:
    _sync(device)
    t0 = time.perf_counter()
    marks = Marks(device)
    issue_ms: List[float] = []
    losses: List[float] = []
    state = {"fit": 0, "left": None, "prof": None, "stretch": None}

    def on_epoch(epoch: int) -> None:
        entered = time.perf_counter()
        i = len(marks.marks)
        ahead = i > 0 and not marks.done(i - 1)
        marks.record()
        in_trace = state["prof"] is not None
        if ahead and state["left"] is not None and not in_trace:
            issue_ms.append((entered - state["left"]) * 1e3)
        if traced and state["fit"] == 0:
            if epoch == TRACE_SKIP:
                _sync(device)
                state["prof"] = _profiler(device)
                state["prof"].start()
                state["t_prof"] = time.perf_counter()
            elif epoch == TRACE_SKIP + TRACE_EPOCHS:
                _sync(device)
                window_s = time.perf_counter() - state["t_prof"]
                state["prof"].stop()
                state["stretch"] = trace.read(state["prof"], TRACE_EPOCHS,
                                              window_s)
                state["prof"] = None
        if i >= DEPTH:
            marks.wait(i - DEPTH)
        if time.perf_counter() - t0 >= seconds:
            _sync(device)
            raise WindowClosed
        state["left"] = time.perf_counter()

    starts = []
    try:
        while True:
            starts.append(len(marks.marks))
            _, _, fit_losses, _, _ = program.fit(config["epochs"], on_epoch)
            losses += fit_losses
            state["fit"] += 1
            state["left"] = None
            if state["fit"] == 1:
                reserved = _reserved(device)
    except WindowClosed:
        if not state["fit"]:
            reserved = _reserved(device)
    if state["prof"] is not None:
        state["prof"].stop()
    ends = [t for t in marks.elapsed_ms() if t <= seconds * 1e3]
    if not ends:
        raise RuntimeError(f"no epoch ended within {seconds} s")
    epoch_ms = list(np.diff([0.0, *ends]))
    _log_fit_starts(epoch_ms, starts)
    return Window(t0, epoch_ms, issue_ms, losses, state["stretch"], reserved)


def _log_fit_starts(epoch_ms: List[float], starts: List[int]) -> None:
    """The ms each fit's first three epochs (warm-ups, capture, teardown of
    the fit before) took beyond three median epochs, on standard error."""
    median = float(np.median(epoch_ms))
    extra = [sum(epoch_ms[i:i + 3]) - 3 * median for i in starts
             if i + 3 <= len(epoch_ms)]
    print(f"fit starts: {len(extra)}, ms beyond the median epoch "
          f"{[round(float(x), 1) for x in extra]}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class RunRecord:
    """What a per-layer metric's reader reads (``metrics/<name>.py``
    ``read(record)``)."""

    config: Dict[str, Any]
    shapes: Dict[str, int]
    plan_build_s: float
    issue_ms: List[float]
    stretch: Optional[trace.Stretch]
    layers: Dict[str, List[str]]

    def layer_ms(self, layer: str) -> Optional[float]:
        """Device ms an epoch of ``layer``'s kernels; None without a
        trace or with none of them in it."""
        if self.stretch is None:
            return None
        return self.stretch.layer_ms(self.layers).get(layer)


def _device_info(device: torch.device, chips: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float) -> Dict[str, Any]:
    """The result line of one run (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, and ``checks``
    last); ``t_start``: the process's start on ``time.perf_counter``."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = cell.config
    log = lambda what: print(f"{time.perf_counter() - t_start:8.2f} s "
                             f"{what}", file=sys.stderr, flush=True)
    log("start")
    inp = inputs.make(cell, seed)
    log("inputs drawn")
    program = system.build(config, inp, inputs.params(config, inp, device),
                           device)
    log(f"program built (plan {program.plan_build_s:.2f} s)")
    readings = system.first_steps(program, config, SETUP_EPOCHS)
    log("set-up fit done")
    window = run_window(program, config, seconds, device, traced)
    log(f"window closed ({len(window.epoch_ms)} epochs)")
    info = _device_info(device, cell.chips)
    edge_types = inputs.program_edges(inp.triples)[2]
    record = RunRecord(config, cost.shapes(config, edge_types),
                       program.plan_build_s, window.issue_ms, window.stretch,
                       spec.kernel_layers())
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = compare.judge(_compare(cell, inp, *readings, device),
                                    cell.limits)
    log("reference compared")
    result: Dict[str, Any] = {
        "correct": correct, "attempted": len(window.epoch_ms),
        "failed": int(sum(not math.isfinite(v) for v in window.losses))}
    if traced:
        result["metrics"] = _per_layer(cell, record)
        if window.stretch is not None:
            info.update(busy_s=window.stretch.busy_s,
                        window_s=window.stretch.window_s)
            result["breakdown"] = window.stretch.breakdown()
    else:
        values = {"step_ms": sum(window.epoch_ms) / len(window.epoch_ms),
                  "step_p95_ms": float(np.percentile(window.epoch_ms, 95)),
                  "peak_reserved_mib": window.reserved / 2**20,
                  "setup_s": window.t0 - t_start}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = info
    result["checks"] = checks
    return result


def _per_layer(cell: spec.Cell, record: RunRecord) -> Dict[str, Any]:
    """Each per-layer metric that its reader finds something for."""
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _compare(cell: spec.Cell, inp: inputs.Inputs, start: rgcn.Readings,
             replay: rgcn.Readings, state: rgcn.State,
             device: torch.device) -> Dict[str, float]:
    """The reference's first step from the same inputs and its step from
    the program's ``state``, and the eight numbers of the program's
    readings against them."""
    config = cell.config
    params0 = inputs.params(config, inp, device)
    edges = rgcn.build_edges(*inp.triples, config["num_entities"], device)
    fit = lambda skip, at: rgcn.fit(
        config, edges, inp.labels, params0, 1,
        inputs.dropout_masks(config, inp, device, skip), state=at)
    return compare.both(config, (start, fit(0, None)),
                        (replay, fit(state.step, state)), params0, state,
                        inp.labels["y_val"])
