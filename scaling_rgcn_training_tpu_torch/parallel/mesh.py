"""Device mesh of the port: S shards along one axis, in one process or
across several.

Counterpart of the JAX package's ``parallel/mesh.py``. One axis, ``"e"``,
carries the partitions (edge chunks or node ranges). In one process a mesh
is S real cards (:func:`make_mesh` ``(n)``) or S explicit entries
(``make_mesh(devices=...)``), which may repeat one device: S virtual shards
on one card, or on the CPU, the port's counterpart of the JAX tests'
virtual CPU mesh.

Across processes (:func:`initialize_multihost`, over
``torch.distributed``), process ``p`` of ``P`` owns the global shards
``[p * k, (p + 1) * k)``, ``k = S / P``: the JAX layout of 2 processes x 4
devices. ``Mesh.devices`` then lists this process's k shards, which lie on
one device: a card of its own, a card the processes share, or the CPU.
:func:`put_global` keeps this process's rows of a node-major host array
(the JAX ``put_global``), :func:`gather_global` puts a node-major array's
rows of every process back together in shard order (the JAX checkpoint's
``process_allgather``), :func:`sum_replicated_grads` sums the replicated
parameters' gradients across processes (the psum XLA inserts for ``P()``
parameters), in rank order, so two runs give the same bits, and
:func:`sum_across` a host number. Host barriers and the exchange of small
objects go over gloo (``Mesh.host_group``, a gloo group of its own under
NCCL); :data:`BARRIER` counts their calls and host seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

EDGE_AXIS = "e"
# how long a process waits for the others in a collective
PROCESS_GROUP_TIMEOUT = datetime.timedelta(seconds=600)

# host barriers of the cross-process exchanges: calls and seconds
BARRIER: Dict[str, float] = {"calls": 0, "seconds": 0.0}

# the gloo group for host barriers and objects when the process group
# runs NCCL (set by initialize_multihost)
_host_group = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: this process's shards, all of the mesh's in one
    process. ``host_group``: the group of host barriers and objects (None:
    the default group). ``peer_sets``: the CUDA IPC buffers of the
    cross-process kernels (``parallel/ipc.py``), made at first use."""

    devices: Tuple[torch.device, ...]
    axis_name: str = EDGE_AXIS
    process_index: int = 0
    process_count: int = 1
    host_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)
    peer_sets: Dict = dataclasses.field(default_factory=dict, compare=False,
                                        repr=False)

    @property
    def size(self) -> int:
        """S, the shards of every process."""
        return len(self.devices) * self.process_count

    @property
    def local_size(self) -> int:
        """k, this process's shards."""
        return len(self.devices)

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.process_index * len(self.devices)

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1

    @property
    def first(self) -> torch.device:
        """The device that holds parameters and node-major activations."""
        return self.devices[0]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join a group of ``num_processes`` processes as ``process_id`` (a
    no-op for one process). Unset arguments come from ``torchrun``'s
    ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.
    ``coordinator_address``: ``host:port`` or an init method URL
    (``tcp://...``, ``file://...``). ``backend``: ``nccl`` by default when
    every process has a card of its own (a process then takes card
    ``LOCAL_RANK``, else ``process_id``), ``gloo`` otherwise; NCCL refuses
    two ranks on one card, so processes that share a card take gloo."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if not num_processes or num_processes <= 1:
        return
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if process_id is None or coordinator_address is None:
        raise ValueError("several processes need a process_id and a "
                         "coordinator_address (or RANK and MASTER_ADDR)")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "nccl" if cards >= num_processes else "gloo"
    init = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)) % cards)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=PROCESS_GROUP_TIMEOUT)
    global _host_group
    _host_group = dist.new_group(backend="gloo",
                                 timeout=PROCESS_GROUP_TIMEOUT) \
        if backend == "nccl" else None


def _processes() -> Tuple[int, int]:
    """(P, this process's rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """In one process, the first ``n_devices`` CUDA devices (all of them by
    default), or the explicit ``devices`` (names or ``torch.device``s,
    repeats allowed). Across processes, this process's shards: the
    explicit ``devices``, one device repeated k times (a card of its own,
    a card the processes share, or the CPU). Raises when fewer CUDA
    devices exist than asked for."""
    procs, rank = _processes()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices {n_devices} != {len(devices)} "
                             "explicit devices")
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
    elif procs > 1:
        raise ValueError(f"across {procs} processes make_mesh takes this "
                         "process's shards: devices=(device,) * k")
    else:
        n = n_devices or have
        if n < 1 or n > have:
            raise RuntimeError(f"asked for a mesh of {n} CUDA devices, have "
                               f"{have} (S virtual shards on one device: "
                               "make_mesh(devices=...); on the CPU: "
                               "-device cpu)")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if procs == 1:
        return Mesh(devs)
    if len(set(devs)) != 1:
        raise ValueError("across processes a process's shards lie on one "
                         f"device, got {[str(d) for d in devs]}")
    if devs[0].type == "cuda" and devs[0].index is None:
        devs = (torch.device("cuda", torch.cuda.current_device()),) * len(devs)
    return Mesh(devs, process_index=rank, process_count=procs,
                host_group=_host_group)


def process_rows(a: np.ndarray, mesh: Mesh) -> np.ndarray:
    """This process's rows of a node-major array of the mesh's S shards."""
    a = np.asarray(a)
    if a.shape[0] % mesh.size:
        raise ValueError(f"{a.shape[0]} rows do not split over {mesh.size} "
                         "shards")
    rows = a.shape[0] // mesh.process_count
    return a[mesh.process_index * rows:(mesh.process_index + 1) * rows]


def put_global(host_array, mesh: Mesh) -> torch.Tensor:
    """A node-major host array ``[S * n_per, ...]`` -> this process's rows
    ``[k * n_per, ...]`` on ``mesh.first`` (every row in one process)."""
    return torch.tensor(process_rows(host_array, mesh), device=mesh.first)


def host_barrier(mesh: Mesh) -> None:
    """Wait for every process of the mesh (host side only); counted and
    timed in :data:`BARRIER`."""
    t0 = time.perf_counter()
    dist.barrier(group=mesh.host_group)
    BARRIER["seconds"] += time.perf_counter() - t0
    BARRIER["calls"] += 1


def gather_objects(obj, mesh: Mesh) -> List[Any]:
    """Every process's picklable ``obj``, in rank order."""
    out: List[Any] = [None] * mesh.process_count
    dist.all_gather_object(out, obj, group=mesh.host_group)
    return out


def _nccl(t: torch.Tensor) -> bool:
    """Whether ``t`` goes over NCCL (a card's tensor in an NCCL group);
    else its bytes go through the host over gloo."""
    return t.device.type == "cuda" and dist.get_backend() == "nccl"


def all_gather_tensor(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every process's ``t`` (one shape and dtype everywhere), in rank
    order, on ``t``'s device."""
    t = t.contiguous()
    if _nccl(t):
        parts = [torch.empty_like(t) for _ in range(mesh.process_count)]
        dist.all_gather(parts, t)
        return parts
    host = t.cpu().view(torch.uint8)
    parts = [torch.empty_like(host) for _ in range(mesh.process_count)]
    dist.all_gather(parts, host, group=mesh.host_group)
    return [p.view(t.dtype).to(t.device) for p in parts]


def all_to_all_rows(send: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``send [P, ...]``: block ``r`` goes to process ``r``; returns
    ``[P, ...]``, block ``r`` from process ``r``. This process's own block
    is copied where it lies; the others move in one
    ``all_to_all_single`` (over NCCL on the card, else their bytes through
    the host over gloo)."""
    me, others = mesh.process_index, [r for r in range(mesh.process_count)
                                      if r != mesh.process_index]
    out = torch.empty_like(send)
    out[me] = send[me]
    block = send[0].numel() * send.element_size()
    if not others or block == 0:
        return out
    idx = torch.tensor(others, device=send.device)
    outgoing = send.index_select(0, idx).reshape(-1).view(torch.uint8)
    splits = [0 if r == me else block for r in range(mesh.process_count)]
    if _nccl(send):
        incoming = torch.empty_like(outgoing)
        dist.all_to_all_single(incoming, outgoing, splits, splits)
    else:
        outgoing = outgoing.cpu()
        incoming = torch.empty_like(outgoing)
        dist.all_to_all_single(incoming, outgoing, splits, splits)
        incoming = incoming.to(send.device)
    out[idx] = incoming.view(send.dtype).view(len(others), *send.shape[1:])
    return out


def gather_global(local, mesh: Mesh) -> np.ndarray:
    """This process's rows of a node-major array (a tensor or numpy array)
    -> the whole array, the processes' rows in shard order, on the host;
    the array itself in one process."""
    if isinstance(local, torch.Tensor):
        local = local.detach().cpu().numpy()
    local = np.asarray(local)
    if not mesh.multiprocess:
        return local
    parts = all_gather_tensor(torch.from_numpy(np.ascontiguousarray(local)),
                              mesh)
    return np.concatenate([p.numpy() for p in parts])


def sum_replicated_grads(params: Iterable[torch.nn.Parameter],
                         mesh: Mesh) -> None:
    """Sum the gradients of parameters every process holds a copy of
    across processes, in place: every process's gradients gathered, then
    added in rank order, so every process and every run gets the same
    bits (a parameter without a gradient counts zeros). A no-op in one
    process."""
    params = list(params)
    if not mesh.multiprocess or not params:
        return
    dtypes = {p.dtype for p in params}
    if len(dtypes) != 1:
        raise TypeError(f"replicated parameters of one dtype, got {dtypes}")
    flat = torch.cat([(p.grad if p.grad is not None else
                       torch.zeros_like(p)).reshape(-1) for p in params])
    parts = all_gather_tensor(flat, mesh)
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    offset = 0
    for p in params:
        g = total[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)


def sum_across(value: float, mesh: Mesh) -> float:
    """A host number summed over the processes, in rank order (float64)."""
    if not mesh.multiprocess:
        return float(value)
    return float(sum(float(v) for v in gather_objects(float(value), mesh)))


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
