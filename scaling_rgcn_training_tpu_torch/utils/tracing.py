"""Profiling and tracing hooks.

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
  them per step for each trace under a directory).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import Counter
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

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
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
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
