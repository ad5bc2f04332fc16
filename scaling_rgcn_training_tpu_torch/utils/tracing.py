"""Profiling and tracing hooks, and the program's own recorder of spans,
counters and device stamps.

Counterpart of the JAX package's ``utils/tracing.py``:

- ``trace(log_dir)``: context manager over ``torch.profiler.profile``
  (CPU activities, and CUDA's where a card is present); on exit it writes
  a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``.
- ``annotate(name)``: a named region of the trace timeline
  (``torch.profiler.record_function``).
- ``throughput(edges, layers, seconds)``: edge traversals per second.
- ``determinism_check(fn, *args)``: runs ``fn`` several times and compares
  every tensor of its outputs bit for bit, the run-to-run determinism audit
  of a step; ``same_bits(a, b)``: the same comparison of two outputs.
- ``gpu_events(trace_path)`` and ``stream_overlap(events)``: the card's
  kernels and copies of a written trace, by card and stream, and how many
  of one stream's kernels run while another stream of their card works
  (``measure_overlap.py``); ``kernels_inside(events, window, compute)``:
  the same count by kernel names and timestamps alone, for a replayed
  CUDA graph, whose kernels run on the graph's own streams
  (``profile_step.py --trace``); ``peer_copy_bytes(events)``: the bytes
  copied card to card (``python -m ...utils.tracing DIR --steps N`` prints
  them per step for each trace under a directory); ``idle_gaps(path,
  slots)``: a trace's largest idle gaps of the card, each with the
  recorder span the host was in and, inside a step, the two marks around
  it.

The recorder (:class:`Recorder`, one a process: ``RECORDER``, and its
methods as module functions), always on:

- ``span(name)``: a context manager that records ``name``, its start and
  end (host ``time.perf_counter_ns``), the span it opened inside (its
  parent, on the same thread) and the fit it belongs to, and opens
  ``annotate(name)``, so under ``torch.profiler`` the same span lies on
  the profiler's clock; ``count(name, value)`` adds to a counter (or sets
  it). ``fit_span()`` opens the ``fit`` span of one ``Trainer.fit`` and
  gives every record made inside it the fit's id. The program opens spans
  per plan, kernel build, fit and epoch, never per kernel: ``plan`` with
  ``plan.norm``, ``plan.sort``, ``plan.cache`` and ``plan.place``
  (``graphs/device.py``, ``ops/rgcn_conv.py``, ``ops/span_kernels.py``,
  ``utils/plancache.py``); ``kernel.build`` and ``kernel.load``
  (``ops/cuda_build.py``); ``fit``, ``fit.prepare``, ``fit.callback`` and
  ``fit.readback`` (``train/trainer.py``); ``fit.warmup``,
  ``fit.capture``, ``fit.step``, ``fit.drain`` (the card's wait for the
  queued steps) and ``fit.close`` (``train/step_graph.py``);
  ``plan.basis`` (``ops/rgcn_conv.py``, the basis kernels' edge order, at
  their first call). Counters: ``kernel_builds``, ``plan.max_row_edges``,
  and one a call of each route: ``att.fused``, ``att.plain``
  (``models/attention.py``), ``basis.fused``, ``basis.plain``
  (``ops/basis_kernels.py``).
- ``mark(name)``: a device stamp inside a running step of a
  ``StepGraph`` (``train/step_graph.py``), a no-op outside one. On a card
  it launches ``step_mark_kernel`` (``csrc/step_marks.cu``, one thread) on
  the current stream, which writes the card's ``%globaltimer`` into the
  step graph's ``stamps[cursor, slot]`` when the kernels queued before it
  are done; it is captured with the step and runs in every replay. On the
  CPU it writes ``perf_counter_ns``. Slots go to the marks in the order
  of the step's first run; every later step must make the same sequence.
  ``grad_mark(x, name)`` marks when the backward reaches ``x`` (an
  identity ``autograd.Function``); where ``x`` needs no grad its slot is
  taken unwritten at the next ``mark(..., settle=True)`` and holds 0, and
  its interval merges into the next one. The step's marks:
  ``step.start``, ``trunk.in``, ``trunk.out`` (the validation forward),
  ``trunk.in``, ``trunk.out`` (the training forward), ``loss``,
  ``trunk.grad``, ``backward``, ``optimizer``, ``step.end``. A
  featureless model (``models/heads.py`` ``FeaturelessModel``) marks
  ``basis.out`` after its basis layer in both forwards and ``basis.grad``
  before ``trunk.grad``, which then stamps the end of that layer's
  backward (it has no input to mark).
- At a fit's end the trainer reads the stamps back with the step outputs
  and records each epoch's layers (:func:`step_layers`): conv
  (``trunk.in`` to ``trunk.out`` and ``loss`` to ``trunk.grad``, through
  ``basis.out`` and ``basis.grad`` where they lie between), optimizer
  (``backward`` to ``optimizer``) and heads (the rest), which add up
  exactly to the epoch's ``step.start`` to ``step.end``; and, of the conv,
  the basis layer (``trunk.in`` to ``basis.out``, ``basis.grad`` to
  ``trunk.grad``) where the step has it.
- The clock: a fit takes one offset between ``%globaltimer`` and the host
  clock (:func:`clock_offset`: one eager mark between two host reads
  around a synchronise) and records it with its uncertainty, half the
  host interval. In a profiler trace the marks are the device events
  named ``step_mark_kernel``: the k-th of a replay is its k-th mark, so it
  places that boundary on the trace's own clock exactly.
- ``spans()``, ``counters()``, ``epochs()`` and ``fits()`` return plain
  dicts for readers (``rgcn_bench/metrics/``); ``reset()`` clears. The
  recorder keeps the last ``FITS_KEPT`` fits' records, and the last
  ``LOOSE_KEPT`` spans outside any fit.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import json
import os
import statistics
import threading
import time
from collections import Counter, deque
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

# the integer type of each float width, to compare floats as bits (a NaN
# equals itself, -0.0 differs from 0.0)
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


@contextlib.contextmanager
def trace(log_dir: Optional[str], **profile_kw) -> Iterator:
    """Profile the block; yields the ``torch.profiler.profile``. On exit
    (also when the block raises) a Chrome trace
    ``trace_<pid>_<time>.json`` is written into ``log_dir`` (made if
    missing; None writes none) and its path set as the profile's
    ``trace_path``. ``profile_kw`` (``schedule``, ``record_shapes``) go to
    the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities, **profile_kw)
    prof.trace_path = None
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            prof.trace_path = os.path.join(
                log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    return torch.profiler.record_function(name)


# -- the recorder: spans, counters and the step's device stamps ---------------

# fits whose records the recorder keeps (the oldest go first)
FITS_KEPT = 256
# spans kept outside any fit (plan builds, other loops' steps)
LOOSE_KEPT = 4096
# the marks a step may make: the columns of a StepGraph's ``stamps``
MAX_SLOTS = 16
# the intervals between two reached marks that are the conv's and the
# optimizer's; every other interval of a step is the heads'
CONV_INTERVALS = frozenset({
    ("trunk.in", "trunk.out"), ("loss", "trunk.grad"),
    ("trunk.in", "basis.out"), ("basis.out", "trunk.out"),
    ("loss", "basis.grad"), ("basis.grad", "trunk.grad")})
# the conv's intervals that are a featureless model's basis layer
BASIS_INTERVALS = frozenset({("trunk.in", "basis.out"),
                             ("basis.grad", "trunk.grad")})
ADAM_INTERVALS = frozenset({("backward", "optimizer")})
# a fit's start: the host's spans besides its replays, the card's wait for
# them (``fit.drain``) and its caller's ``on_epoch`` (see fit_start_ns)
FIT_START = ("fit.prepare", "fit.warmup", "fit.capture", "fit.readback",
             "fit.close")


class Recorder:
    """Spans, counters and stamped epochs in memory (see the module),
    bounded to the last ``fits`` fits. Records may come from several
    threads (autograd runs a card's backward on a thread of its own)."""

    def __init__(self, fits: int = FITS_KEPT):
        self.fits_kept = fits
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            # fit id (None: no fit) -> its spans
            self._spans: Dict[Optional[int], Any] = {
                None: deque(maxlen=LOOSE_KEPT)}
            self._epochs: Dict[int, List[dict]] = {}
            self._fits: Dict[int, dict] = {}
            self._counters: Dict[str, float] = {}
            self._next_span = 0
            self._next_fit = 0
            self.fit_id: Optional[int] = None

    def _stack(self) -> List[int]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[None]:
        """Record the block as span ``name`` (``args``: what else the
        record keeps, e.g. the sources a build compiles), inside
        ``annotate(name)``."""
        stack = self._stack()
        with self._lock:
            sid = self._next_span
            self._next_span += 1
        record = {"id": sid, "name": name, "parent": stack[-1] if stack
                  else None, "fit": self.fit_id}
        if args:
            record["args"] = args
        stack.append(sid)
        record["start_ns"] = time.perf_counter_ns()
        try:
            with annotate(name):
                yield
        finally:
            record["end_ns"] = time.perf_counter_ns()
            stack.pop()
            with self._lock:
                self._spans.get(record["fit"], self._spans[None]).append(
                    record)

    @contextlib.contextmanager
    def fit_span(self) -> Iterator[int]:
        """The ``fit`` span of a new fit; yields its id, which every record
        made inside it carries."""
        with self._lock:
            fit = self._next_fit
            self._next_fit += 1
            self._fits[fit] = {"fit": fit}
            self._spans[fit] = []
            self._epochs[fit] = []
            while len(self._fits) > self.fits_kept:
                old = next(iter(self._fits))
                for records in (self._fits, self._spans, self._epochs):
                    del records[old]
        outer, self.fit_id = self.fit_id, fit
        try:
            with self.span("fit"):
                yield fit
        finally:
            self.fit_id = outer

    def count(self, name: str, value: float = 1, add: bool = True) -> None:
        """Add ``value`` to counter ``name`` (or set it: ``add=False``)."""
        with self._lock:
            self._counters[name] = \
                self._counters.get(name, 0) + value if add else value

    def note_fit(self, fit: int, **values) -> None:
        """Keep ``values`` (the clock offset) in the record of ``fit``."""
        with self._lock:
            if fit in self._fits:
                self._fits[fit].update(values)

    def record_steps(self, fit: int, names: Sequence[str],
                     kinds: Sequence[str], rows: Sequence[Sequence[int]],
                     first_epoch: int = 0) -> None:
        """A fit's stamped steps: each row of stamps (``names``' slots) as
        an epoch record (``epoch``, ``kind``: ``"warmup"``, ``"replay"``
        or ``"eager"``, :func:`step_layers`, ``stamps``)."""
        records = [dict(step_layers(names, row), fit=fit, epoch=first_epoch
                        + i, kind=kind, stamps=[int(t) for t in row])
                   for i, (kind, row) in enumerate(zip(kinds, rows))]
        with self._lock:
            if fit in self._fits:
                self._fits[fit]["slots"] = list(names)
                self._epochs[fit].extend(records)

    def spans(self, fit: Any = ...) -> List[dict]:
        """Every span kept (or those of ``fit``; None: outside any fit),
        by start."""
        with self._lock:
            kept = self._spans.values() if fit is ... else \
                [self._spans.get(fit, ())]
            out = [dict(r) for records in kept for r in records]
        return sorted(out, key=lambda r: r["start_ns"])

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def epochs(self, fit: Any = ...) -> List[dict]:
        """Every stamped epoch kept (or those of ``fit``), by fit and
        epoch."""
        with self._lock:
            kept = self._epochs.values() if fit is ... else \
                [self._epochs.get(fit, ())]
            return [dict(r) for records in kept for r in records]

    def fits(self) -> List[dict]:
        """Each fit kept, in order: ``fit``, and where known
        ``clock_offset_ns``, ``clock_uncertainty_ns`` and ``slots``."""
        with self._lock:
            return [dict(r) for r in self._fits.values()]


RECORDER = Recorder()
span = RECORDER.span
fit_span = RECORDER.fit_span
count = RECORDER.count
note_fit = RECORDER.note_fit
record_steps = RECORDER.record_steps
spans = RECORDER.spans
counters = RECORDER.counters
epochs = RECORDER.epochs
fits = RECORDER.fits
reset = RECORDER.reset


def step_layers(names: Sequence[str], stamps: Sequence[int]) -> Dict[str, int]:
    """One step's stamps (0: a mark the step did not reach) ->
    ``start_ns`` and ``end_ns`` (its first and last reached marks,
    ``step.start`` and ``step.end``), and ``conv_ns``, ``head_ns`` and
    ``adam_ns``: each interval between two consecutive reached marks by
    ``CONV_INTERVALS`` and ``ADAM_INTERVALS``, else the heads'. The three
    add up to ``end_ns - start_ns`` exactly. Where the step reached a
    ``BASIS_INTERVALS`` pair, ``basis_ns``: those intervals, a part of
    ``conv_ns``."""
    reached = [(n, int(t)) for n, t in zip(names, stamps) if t]
    out = {"start_ns": reached[0][1] if reached else 0,
           "end_ns": reached[-1][1] if reached else 0,
           "conv_ns": 0, "head_ns": 0, "adam_ns": 0}
    for (a, lo), (b, hi) in zip(reached, reached[1:]):
        layer = "conv_ns" if (a, b) in CONV_INTERVALS else \
            "adam_ns" if (a, b) in ADAM_INTERVALS else "head_ns"
        out[layer] += hi - lo
        if (a, b) in BASIS_INTERVALS:
            out["basis_ns"] = out.get("basis_ns", 0) + hi - lo
    return out


def replay_layers(fit: Optional[int] = None) -> Dict[str, List[int]]:
    """Over the replayed epochs (of ``fit``, or of every fit kept): each
    one's ``conv``, ``head`` and ``adam`` ns, ``basis`` (the replays with
    a basis layer: its ns, a part of ``conv``), and ``between``: from a
    replay's ``step.end`` to the ``step.start`` of the fit's next epoch,
    where that is a replay too."""
    out: Dict[str, List[int]] = {"conv": [], "head": [], "adam": [],
                                 "basis": [], "between": []}
    records = epochs() if fit is None else epochs(fit)
    for r in records:
        if r["kind"] == "replay":
            for layer in ("conv", "head", "adam"):
                out[layer].append(r[f"{layer}_ns"])
            if "basis_ns" in r:
                out["basis"].append(r["basis_ns"])
    for a, b in zip(records, records[1:]):
        if a["kind"] == b["kind"] == "replay" and a["fit"] == b["fit"] \
                and b["epoch"] == a["epoch"] + 1:
            out["between"].append(b["start_ns"] - a["end_ns"])
    return out


def fit_start_ns(fit: int) -> Optional[int]:
    """A finished fit's start: its ``FIT_START`` spans' ns summed (the
    preparation, the warm-ups, the capture, the readback and the
    teardown), less its warm-up epochs' stamped ``step.start`` to
    ``step.end``: those are real epochs, and the card's work in them is
    not the start's (on a card it runs while the host warms up and
    captures). None for a fit without a ``fit.readback`` (cut short) or
    no longer kept."""
    own = [r for r in spans(fit) if r["name"] in FIT_START]
    if not any(r["name"] == "fit.readback" for r in own):
        return None
    warm = sum(r["end_ns"] - r["start_ns"] for r in epochs(fit)
               if r["kind"] == "warmup")
    return sum(r["end_ns"] - r["start_ns"] for r in own) - warm


def fit_line(fit: int) -> Optional[str]:
    """The operator's line for a fit: median ms an epoch of the conv, the
    heads and the optimizer over its replays, ms between its steps, and
    its start's ms; None for a fit with no replay."""
    layers = replay_layers(fit)
    if not layers["conv"]:
        return None
    ms = lambda v: f"{statistics.median(v) / 1e6:.3f}" if v else "-"
    start = fit_start_ns(fit)
    return (f"step spans over {len(layers['conv'])} replays, median ms an "
            f"epoch: conv {ms(layers['conv'])}, heads {ms(layers['head'])}, "
            f"optimizer {ms(layers['adam'])}, between steps "
            f"{ms(layers['between'])}; fit start "
            f"{'-' if start is None else f'{start / 1e6:.1f}'} ms")


# -- device stamps inside a step ----------------------------------------------

# the StepMarks of the step running now (set by StepMarks.step; read from
# autograd's threads too, so not thread-local)
_running: Optional["StepMarks"] = None


def _declare_marks(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.step_mark.argtypes = [p, p, i, i, ctypes.c_longlong, p]
    lib.step_mark.restype = i


def _stamp(stamps: torch.Tensor, cursor: torch.Tensor, slot: int) -> None:
    """The clock into ``stamps[cursor, slot]``, in stream order: on a card
    ``step_mark_kernel`` on the current stream (``%globaltimer``, read
    when it runs), on the CPU ``perf_counter_ns`` (no host read of
    ``cursor``)."""
    if stamps.device.type != "cuda":
        stamps.select(1, slot).index_fill_(0, cursor, time.perf_counter_ns())
        return
    from scaling_rgcn_training_tpu_torch.ops import cuda_build

    lib = cuda_build.load("step_marks", _declare_marks)
    with torch.cuda.device(stamps.device):
        err = lib.step_mark(cursor.data_ptr(), stamps.data_ptr(),
                            stamps.shape[1], slot, stamps.shape[0],
                            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(lib, err, "step_mark")


class StepMarks:
    """The marks of a step graph's steps: ``stamps [steps, MAX_SLOTS]``
    (int64, zeros) written at row ``cursor`` (the step graph's device
    cursor, ``[1]`` int64) and ``names``, the slots' marks in the order
    of the first step (see the module)."""

    def __init__(self, stamps: torch.Tensor, cursor: torch.Tensor):
        self.stamps = stamps
        self.cursor = cursor
        self.names: List[str] = []
        self._fixed = False
        self._next = 0
        self._armed: List[str] = []

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        """One step: ``mark`` writes into this step's row inside it."""
        global _running
        self._next, self._armed = 0, []
        outer, _running = _running, self
        try:
            yield
            self._fixed = True
        finally:
            _running = outer

    def _claim(self, name: str) -> int:
        slot = self._next
        if not self._fixed:
            if slot >= self.stamps.shape[1]:
                raise RuntimeError(f"more than {self.stamps.shape[1]} marks "
                                   f"in a step: {self.names + [name]}")
            self.names.append(name)
        elif self.names[slot:slot + 1] != [name]:
            raise RuntimeError(f"mark {name!r} in slot {slot}; the first step "
                               f"marked {self.names}")
        self._next += 1
        return slot

    def mark(self, name: str, settle: bool = False) -> None:
        if settle:
            for armed in self._armed:
                self._claim(armed)
            self._armed = []
        _stamp(self.stamps, self.cursor, self._claim(name))

    def arm(self, name: str) -> None:
        self._armed.append(name)

    def fire(self, name: str) -> None:
        if name in self._armed:
            self._armed.remove(name)
            _stamp(self.stamps, self.cursor, self._claim(name))


def mark(name: str, settle: bool = False) -> None:
    """Stamp ``name`` in the running step (a no-op outside one); with
    ``settle``, first take the slots of the grad marks armed in this step
    whose backward did not run, unwritten."""
    marks = _running
    if marks is not None:
        marks.mark(name, settle)


class _GradMark(torch.autograd.Function):
    """The identity; its backward marks ``name``."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        marks = _running
        if marks is not None:
            marks.fire(ctx.name)
        return grad, None


def grad_mark(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, through an identity whose backward marks ``name`` (inside a
    running step, with grad enabled; else ``x`` itself). The mark's slot
    is armed here, so where ``x`` needs no grad the next ``mark(...,
    settle=True)`` takes it unwritten."""
    marks = _running
    if marks is None or not torch.is_grad_enabled():
        return x
    marks.arm(name)
    return _GradMark.apply(x, name) if x.requires_grad else x


def clock_offset(device) -> Tuple[int, int]:
    """The card's ``%globaltimer`` minus the host's ``perf_counter_ns`` and
    the uncertainty of that offset (half the host interval around one
    eager mark between two synchronises), in ns; ``(0, 0)`` off a card,
    where marks take the host clock."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0, 0
    stamps = torch.zeros((1, 1), dtype=torch.int64, device=device)
    cursor = torch.zeros(1, dtype=torch.int64, device=device)
    _stamp(stamps, cursor, 0)       # the library built and loaded first
    torch.cuda.synchronize(device)
    lo = time.perf_counter_ns()
    _stamp(stamps, cursor, 0)
    torch.cuda.synchronize(device)
    hi = time.perf_counter_ns()
    return int(stamps.item()) - (lo + hi) // 2, (hi - lo + 1) // 2


def throughput(num_edges: int, num_layers: int, seconds: float) -> float:
    """edge traversals per second (the BASELINE.json north-star metric)."""
    return num_edges * num_layers / max(seconds, 1e-12)


def _leaves(tree: Any) -> List[Any]:
    """The leaves of nested tuples, lists and dicts (dict keys in order,
    keys included), depth first."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in [k, *_leaves(v)]]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _same_bits(a: Any, b: Any) -> bool:
    if not isinstance(a, torch.Tensor):
        if isinstance(a, (np.ndarray, np.generic, float, int, bool)):
            a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
        else:
            return a == b
    if not isinstance(b, torch.Tensor) or a.dtype != b.dtype or \
            a.shape != b.shape or a.device != b.device:
        return False
    if a.is_floating_point():
        a, b = (t.contiguous().view(_BITS[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def same_bits(ref: Any, got: Any) -> bool:
    """True when two outputs have the same structure and every tensor (and
    number, and array) leaf the same bits."""
    ref, got = _leaves(ref), _leaves(got)
    return len(got) == len(ref) and \
        all(_same_bits(a, b) for a, b in zip(ref, got))


def determinism_check(fn: Callable, *args, tries: int = 2) -> bool:
    """True when ``tries`` runs of ``fn(*args)`` give outputs with the
    same structure and every leaf the same bits (:func:`same_bits`)."""
    ref = fn(*args)
    return all(same_bits(ref, fn(*args)) for _ in range(tries - 1))


# the card's activities in a Chrome trace: kernels, copies and fills
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# the host's calls that launch them (their correlation ids link the two)
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def gpu_events(trace_path: str) -> List[Dict[str, Any]]:
    """The card's kernels, copies and fills in a Chrome trace that
    :func:`trace` wrote, in start order: ``name``, ``cat`` (``kernel``,
    ``gpu_memcpy``, ``gpu_memset``), ``device``, ``stream``, ``start``,
    ``end``, ``launch`` (microseconds; ``launch``: when the host's
    runtime or driver call that queued it began, None where the trace
    links none) and ``bytes`` (a copy's or fill's, else 0)."""
    events = _trace_events(trace_path)
    launched = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() in \
                _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = float(e["ts"])
    out = []
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in _DEVICE_CATS:
            continue
        args = e.get("args", {})
        start = float(e["ts"])
        out.append({"name": e["name"], "cat": cat,
                    "device": int(args.get("device", e.get("pid", 0))),
                    "stream": int(args.get("stream", e.get("tid", 0))),
                    "start": start, "end": start + float(e.get("dur", 0.0)),
                    "launch": launched.get(args.get("correlation")),
                    "bytes": int(args.get("bytes", 0))})
    return sorted(out, key=lambda e: e["start"])


def _trace_events(trace_path: str) -> List[Dict[str, Any]]:
    with open(trace_path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def idle_gaps(trace_path: str, slots: Sequence[str],
              top: int = 5) -> List[Dict[str, Any]]:
    """The card's ``top`` largest idle gaps (between the union's intervals
    of :func:`gpu_events`) in a Chrome trace of replayed steps, largest
    first: ``start`` (microseconds), ``ms``, ``span``: the innermost
    recorder span (a host ``user_annotation``) the host was in at the
    gap's middle (None: none), and ``marks``: for a gap inside one step,
    the two marks around it, else None. The k-th ``step_mark_kernel`` of
    a step is its slot k of ``slots`` (the step's ``marks.names``); the
    trace must start at a step's first mark, as a trace opened between
    two epochs does."""
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e["name"]) for e in _trace_events(trace_path)
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    device = gpu_events(trace_path)
    ends = [e["end"] for e in device if e["cat"] == "kernel"
            and kernel_name(e["name"]) == "step_mark_kernel"]
    busy = _union([(e["start"], e["end"]) for e in device])
    gaps = sorted(((b_lo - a_hi, a_hi, b_lo) for (_, a_hi), (b_lo, _)
                   in zip(busy, busy[1:])), reverse=True)[:top]
    out = []
    for length, lo, hi in gaps:
        mid = (lo + hi) / 2
        inside = [(b - a, name) for a, b, name in host if a <= mid <= b]
        # the last mark done by the gap's start, and the next one
        k = bisect.bisect_right(ends, lo) - 1
        n = len(slots)
        marks = None
        if 0 <= k < len(ends) - 1 and n and k // n == (k + 1) // n:
            marks = (slots[k % n], slots[(k + 1) % n])
        out.append({"start": lo, "ms": length / 1e3,
                    "span": min(inside)[1] if inside else None,
                    "marks": marks})
    return out


def kernel_name(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name[5:] if name.startswith("void ") else name


def _union(intervals: List[tuple]) -> List[List[float]]:
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def stream_overlap(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """On each card of :func:`gpu_events`, the stream with the most events
    is its compute stream and the other streams' events are the window
    (the halo exchange's stream, ``parallel/ring_halo.py``). Returns
    ``inside``: the compute stream's kernels that run while the window
    works (their intervals meet), ``kernels``: those kernels by name,
    ``window_ms``: the window's busy ms (its events' union),
    ``overlap_ms``: the ms in which a compute kernel runs beside it;
    ``windows``: the window's separate busy intervals, ``host_late``: how
    many of them ended before the host had launched the next compute
    kernel (the first one still to run when the interval began): there
    the host's pace, not a stream's wait, kept the streams apart;
    ``busy_ms`` and ``span_ms``: every stream's union of events and the
    first start to the last end, summed over the cards (idle share ``1 -
    busy / span``); ``streams``: each card's compute and window
    streams."""
    by_dev: Dict[int, List[Dict[str, Any]]] = {}
    for e in events:
        by_dev.setdefault(e["device"], []).append(e)
    inside, names = 0, Counter()
    window_us = overlap_us = busy_us = span_us = 0.0
    windows = host_late = 0
    streams = {}
    for dev, evs in sorted(by_dev.items()):
        compute = Counter(e["stream"] for e in evs).most_common(1)[0][0]
        window = _union([(e["start"], e["end"]) for e in evs
                         if e["stream"] != compute])
        streams[str(dev)] = {"compute": compute, "window": sorted(
            {e["stream"] for e in evs if e["stream"] != compute})}
        window_us += sum(hi - lo for lo, hi in window)
        busy_us += sum(hi - lo for lo, hi in
                       _union([(e["start"], e["end"]) for e in evs]))
        span_us += max(e["end"] for e in evs) - min(e["start"] for e in evs)
        kernels = [e for e in evs
                   if e["stream"] == compute and e["cat"] == "kernel"]
        starts = [lo for lo, _ in window]
        for e in kernels:
            met = 0.0
            i = max(bisect.bisect_right(starts, e["start"]) - 1, 0)
            for lo, hi in window[i:]:
                if lo >= e["end"]:
                    break
                met += max(0.0, min(hi, e["end"]) - max(lo, e["start"]))
            if met > 0:
                inside += 1
                names[kernel_name(e["name"])] += 1
                overlap_us += met
        for lo, hi in window:
            nxt = next((e for e in kernels if e["end"] > lo), None)
            if nxt is None:
                continue
            windows += 1
            if nxt["launch"] is not None and nxt["launch"] >= hi:
                host_late += 1
    return {"inside": inside, "kernels": dict(names.most_common()),
            "window_ms": window_us / 1e3, "overlap_ms": overlap_us / 1e3,
            "windows": windows, "host_late": host_late,
            "busy_ms": busy_us / 1e3, "span_ms": span_us / 1e3,
            "streams": streams}


def kernels_inside(events: Sequence[Dict[str, Any]],
                   window: Callable[[str], bool],
                   compute: Callable[[str], bool]) -> Dict[str, Any]:
    """By timestamps alone (a replayed CUDA graph runs its branches on
    streams of its own, so a stream id says nothing of which work it
    holds): the window is the union of the kernels of :func:`gpu_events`
    whose name (:func:`kernel_name`) ``window`` accepts, e.g. the halo
    exchange's; returns ``inside``, how many kernels that ``compute``
    accepts run while the window works (their intervals meet),
    ``kernels`` those by name, ``window_ms``, ``overlap_ms`` (the ms in
    which one of them runs beside it), ``busy_ms`` (the union of every
    event) and ``streams`` (the distinct stream ids)."""
    kernels = [e for e in events if e["cat"] == "kernel"]
    win = _union([(e["start"], e["end"]) for e in kernels
                  if window(kernel_name(e["name"]))])
    starts = [lo for lo, _ in win]
    inside, names, overlap = 0, Counter(), []
    for e in kernels:
        name = kernel_name(e["name"])
        if window(name) or not compute(name):
            continue
        met = []
        i = max(bisect.bisect_right(starts, e["start"]) - 1, 0)
        for lo, hi in win[i:]:
            if lo >= e["end"]:
                break
            if min(hi, e["end"]) > max(lo, e["start"]):
                met.append((max(lo, e["start"]), min(hi, e["end"])))
        if met:
            inside += 1
            names[name] += 1
            overlap += met
    return {"inside": inside, "kernels": dict(names.most_common()),
            "window_ms": sum(hi - lo for lo, hi in win) / 1e3,
            "overlap_ms": sum(hi - lo for lo, hi in _union(overlap)) / 1e3,
            "busy_ms": sum(hi - lo for lo, hi in _union(
                [(e["start"], e["end"]) for e in events])) / 1e3,
            "streams": len({(e["device"], e["stream"]) for e in events})}


def peer_copy_bytes(events: Sequence[Dict[str, Any]]) -> int:
    """The bytes of the copies from one card to another (the profiler's
    ``Memcpy PtoP``) among :func:`gpu_events`: what PyTorch's copies move
    between cards. A kernel's own reads of a peer's memory (#6, #7) are
    no copy and are not in it."""
    return sum(e["bytes"] for e in events
               if e["cat"] == "gpu_memcpy" and "PtoP" in e["name"])


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m scaling_rgcn_training_tpu_torch.utils.tracing DIR
    --steps N``: each Chrome trace under ``DIR`` (recursively; e.g.
    ``bench_scaling --trace DIR``'s ``k<count>`` folders, of this tree or
    another) with its peer copies' MB per step over ``N`` traced steps,
    one JSON line."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args(argv)
    out = {}
    for root, _, files in sorted(os.walk(args.dir)):
        for name in sorted(files):
            if name.startswith("trace_") and name.endswith(".json"):
                path = os.path.join(root, name)
                out[os.path.relpath(path, args.dir)] = peer_copy_bytes(
                    gpu_events(path)) / 1e6 / args.steps
    print(json.dumps({"peer_copy_mb_per_step": out}), flush=True)


if __name__ == "__main__":
    main()
