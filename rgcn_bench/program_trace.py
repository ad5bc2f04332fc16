"""The program's own recorder, for the readers of ``metrics/``: the
spans, counters and stamped epochs that ``scaling_rgcn_training_tpu_torch``
keeps in memory (``utils/tracing.py``), in this process. A program
without that recorder gives ``None``, and so does each reader: its
metric is left out of the result line."""

from __future__ import annotations

import statistics
from types import ModuleType
from typing import List, Optional


def recorder() -> Optional[ModuleType]:
    """The port's ``utils/tracing.py`` where it has the recorder."""
    try:
        from scaling_rgcn_training_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing if hasattr(tracing, "replay_layers") else None


def median_ms(values_ns: List[int]) -> Optional[float]:
    return statistics.median(values_ns) / 1e6 if values_ns else None


def replay_median_ms(layer: str) -> Optional[float]:
    """Median ms of ``layer`` (``conv``, ``head``, ``adam`` or
    ``between``) over every replayed epoch of every fit kept."""
    tracing = recorder()
    return None if tracing is None else \
        median_ms(tracing.replay_layers()[layer])


def span_s(names: List[str]) -> Optional[float]:
    """Seconds of every kept span named in ``names``, summed; None where
    there is none."""
    tracing = recorder()
    if tracing is None:
        return None
    found = [r for r in tracing.spans() if r["name"] in names]
    if not found:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in found) / 1e9
