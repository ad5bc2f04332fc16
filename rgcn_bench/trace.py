"""A traced stretch of the window, read from ``torch.profiler``: the
device's kernels (inside CUDA graph replays too) and the host's events
on one clock, the device's busy time as the union of its kernels'
intervals, each kernel's layer by the kernel-name tables
(``kernel_layers/*.json``; a kernel in no table is a torch op), and the
breakdown: the device ops that took most time and the idle gaps by what
the host was doing meanwhile.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# the layer of a kernel in no table
TORCH_OPS = "torch ops"
_TOP = 10


@dataclasses.dataclass
class Stretch:
    """``epochs`` epochs traced over ``window_s`` seconds: each device op
    ``(name, start_us, end_us)`` and each host event likewise."""

    epochs: int
    window_s: float
    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in union(self.device_ops)) / 1e6

    def layer_ms(self, tables: Dict[str, List[str]]) -> Dict[str, float]:
        """Device ms an epoch by layer."""
        out: Dict[str, float] = defaultdict(float)
        for name, lo, hi in self.device_ops:
            out[layer_of(name, tables)] += (hi - lo) / 1e3 / self.epochs
        return dict(out)

    def breakdown(self) -> Dict[str, List[list]]:
        """The ``_TOP`` device ops by seconds over the stretch, and the
        ``_TOP`` idle gaps' seconds by the innermost host event that was
        running at each gap's middle."""
        ops: Dict[str, float] = defaultdict(float)
        for name, lo, hi in self.device_ops:
            ops[name] += (hi - lo) / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        spans = union(self.device_ops)
        for (_, end), (start, _) in zip(spans, spans[1:]):
            gaps[_host_at((end + start) / 2, self.host_ops)] += \
                (start - end) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:_TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def union(ops) -> List[Tuple[float, float]]:
    """The merged ``(start, end)`` intervals of ``ops``."""
    out: List[List[float]] = []
    for lo, hi in sorted((op[-2], op[-1]) for op in ops):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _host_at(t: float, host_ops) -> str:
    inside = [(hi - lo, name) for name, lo, hi in host_ops if lo <= t <= hi]
    return min(inside)[1] if inside else "no host event"


def layer_of(kernel: str, tables: Dict[str, List[str]]) -> str:
    for layer, names in tables.items():
        if any(n in kernel for n in names):
            return layer
    return TORCH_OPS


def read(prof, epochs: int, window_s: float) -> Optional[Stretch]:
    """The stretch from a stopped profiler; None where it holds no device
    op (no card, or a profiler that saw none)."""
    device_ops, host_ops = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device_ops.append(span)
        else:
            host_ops.append(span)
    if not device_ops:
        return None
    return Stretch(epochs, window_s, device_ops, host_ops)
