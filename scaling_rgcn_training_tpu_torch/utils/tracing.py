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
  of a step.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator, List, Optional

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


def determinism_check(fn: Callable, *args, tries: int = 2) -> bool:
    """True when ``tries`` runs of ``fn(*args)`` give outputs with the
    same structure and every tensor (and number, and array) leaf the same
    bits."""
    ref = _leaves(fn(*args))
    for _ in range(tries - 1):
        got = _leaves(fn(*args))
        if len(got) != len(ref) or \
                not all(_same_bits(a, b) for a, b in zip(ref, got)):
            return False
    return True
