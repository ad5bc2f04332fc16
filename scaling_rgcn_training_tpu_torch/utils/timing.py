"""Wall-clock banner logger + phase timers.

Reproduces the reference's progress tracer (helpers/timing.py:7-29:
module-import start timestamp, ``log`` banners at pipeline milestones, and
an atexit end-of-program elapsed print) and adds named phase timers for
throughput accounting (edges/s — the north-star metric).
"""

from __future__ import annotations

import atexit
import time
from contextlib import contextmanager
from datetime import timedelta
from time import localtime, strftime
from typing import Dict, List


def seconds_to_str(elapsed: float | None = None) -> str:
    if elapsed is None:
        return strftime("%Y-%m-%d %H:%M:%S", localtime())
    return str(timedelta(seconds=elapsed))


_RULE = 40 * "="


def log(s: str, elapsed: str | None = None) -> None:
    body = [f"{seconds_to_str()} - {s}"]
    if elapsed:
        body.append(f"Elapsed time: {elapsed}")
    print("\n".join([_RULE, *body, _RULE, ""]))


def endlog() -> None:
    log("End Program", seconds_to_str(time.time() - start))


# named phase timers -------------------------------------------------------

_phases: Dict[str, List[float]] = {}


@contextmanager
def phase(name: str):
    """Accumulating wall-clock timer: ``with timing.phase('train_epoch'): ...``"""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _phases.setdefault(name, []).append(time.perf_counter() - t0)


def phase_totals() -> Dict[str, float]:
    return {k: sum(v) for k, v in _phases.items()}


start = time.time()


def enable_program_banner() -> None:
    """CLI entry points opt into the reference's start/end banners
    (helpers/timing.py:22-29 registers these unconditionally at import; as a
    library we only do it for the CLI)."""
    global start
    start = time.time()
    log("Start Program")
    atexit.register(endlog)
