"""Wall-clock banner logger.

Reproduces the reference's progress tracer (helpers/timing.py:7-29:
module-import start timestamp, ``log`` banners at pipeline milestones, and
an atexit end-of-program elapsed print). The program's timed spans are
``utils/tracing.py``'s recorder.
"""

from __future__ import annotations

import atexit
import time
from datetime import timedelta
from time import localtime, strftime


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


start = time.time()


def enable_program_banner() -> None:
    """CLI entry points opt into the reference's start/end banners
    (helpers/timing.py:22-29 registers these unconditionally at import; as a
    library we only do it for the CLI)."""
    global start
    start = time.time()
    log("Start Program")
    atexit.register(endlog)
