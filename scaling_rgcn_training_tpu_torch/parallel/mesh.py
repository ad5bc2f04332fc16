"""Device mesh of the port: a tuple of ``torch.device``s along one axis.

Counterpart of the JAX package's ``parallel/mesh.py``. One axis, ``"e"``,
carries the partitions (edge chunks or node ranges). A mesh is S real
cards (:func:`make_mesh` ``(n)``) or S explicit entries
(``make_mesh(devices=...)``), which may repeat one device: S virtual
shards on one card, or on the CPU, the port's counterpart of the JAX
tests' virtual CPU mesh. Everything runs in one process; several
processes over ``torch.distributed`` are not ported (ROADMAP.md queue 1).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import torch

EDGE_AXIS = "e"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S shard devices along the axis ``axis_name``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = EDGE_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device that holds parameters and node-major activations."""
        return self.devices[0]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The first ``n_devices`` CUDA devices (all of them by default), or
    the explicit ``devices`` (names or ``torch.device``s, repeats allowed).
    Raises when fewer CUDA devices exist than asked for."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices {n_devices} != {len(devices)} "
                             "explicit devices")
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return Mesh(devs)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or have
    if n < 1 or n > have:
        raise RuntimeError(f"asked for a mesh of {n} CUDA devices, have "
                           f"{have} (S virtual shards on one device: "
                           "make_mesh(devices=...); on the CPU: -device cpu)")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


_current_mesh: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    return _current_mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Ambient mesh for the partitioned conv dispatch (ops/rgcn_conv.py)."""
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = prev
