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

A node-major array on a mesh (the embedding, a layer's activations) is a
:class:`NodeRows`: one tensor per shard of this process, on that shard's
device, shard ``s`` holding the global rows ``[s * n_per, (s + 1) *
n_per)`` (the JAX package's array placed with ``parallel/halo.py``
``node_sharding``). Shards that share a device (virtual shards, or 8
shards on 4 cards) still get one tensor each, so one card and several
take the same code. :func:`node_sharding` places a host array,
:func:`pad_node_array` pads one to ``S * n_per`` rows,
:func:`shard_rows` splits a tensor of this process's rows under
autograd, :meth:`NodeRows.gather` puts the shards back together in shard
order on one device (evaluation, checkpoints, ``-e_viz``; never the step)
and :class:`RowPick` takes given rows (the labelled ones) onto one
device. :class:`Replicate` hands a replicated parameter (the JAX ``P()``)
to each shard's device and adds its cotangents back in a fixed order.
:data:`CROSS_CARD` counts the bytes these copies, the halo exchanges and
the kernels' peer reads move between the cards of this process.

:func:`put_global` (also :func:`node_sharding`) places this process's
rows of a node-major host array (the JAX ``put_global``),
:func:`gather_global` puts a node-major array's rows of every process
back together in shard order (the JAX checkpoint's
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

# bytes copied between two cards of this process (count_cross_card)
CROSS_CARD: Dict[str, int] = {"bytes": 0}

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
        """The device of this process's first shard. It holds the
        replicated parameters (the JAX ``P()``: the layers' weights, root
        and bias, which reach the other devices through
        :class:`Replicate`) and what is gathered onto one device (the
        labelled rows' logits and the loss); each shard's node-major rows
        lie on its own device (:class:`NodeRows`)."""
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


def norm_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its card's index (``"cuda"``
    -> the current card), so two names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def count_cross_card(t: torch.Tensor, device) -> None:
    """Add ``t``'s bytes to :data:`CROSS_CARD` when it is copied from one
    card to another."""
    device = norm_device(device)
    if t.device.type == "cuda" and device.type == "cuda" and \
            t.device != device:
        CROSS_CARD["bytes"] += t.numel() * t.element_size()


def copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)``, counted in :data:`CROSS_CARD` (no autograd)."""
    count_cross_card(t, device)
    return t.to(device)


class _Move(torch.autograd.Function):
    """``t`` copied to ``device``; the cotangent copied back. Both copies
    are counted in :data:`CROSS_CARD`."""

    @staticmethod
    def forward(ctx, t, device):
        ctx.home = t.device
        return copy_to(t, device)

    @staticmethod
    def backward(ctx, g):
        return copy_to(g, ctx.home), None


def move(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` under autograd (``t`` itself when it lies
    there), the copies both ways counted."""
    device = norm_device(device)
    return t if t.device == device else _Move.apply(t, device)


class Replicate(torch.autograd.Function):
    """A replicated tensor (the JAX ``P()``) handed to each of
    ``devices``: ``(t, devices, groups)`` -> one tensor per entry of
    ``devices``, an alias where it is ``t``'s device, else one copy per
    distinct device, shared by its entries. ``groups``: every output's
    index once, in the order its cotangents are added. A group's
    cotangents lie on one device and are added there first, then each
    group's sum is brought back and added in order; so the sum is the
    same whichever autograd thread finishes first.
    :func:`replicate_groups` makes the groups."""

    @staticmethod
    def forward(ctx, t, devices, groups):
        ctx.home, ctx.groups = t.device, groups
        copies = {}
        for dev in dict.fromkeys(devices):
            if dev != t.device:
                copies[dev] = copy_to(t, dev)
        return tuple(t.view_as(t) if dev == t.device else
                     copies[dev].view_as(t) for dev in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for group in ctx.groups:
            part = None
            for i in group:
                g = grads[i]
                if g is not None:
                    part = g if part is None else part + g
            if part is None:
                continue
            part = copy_to(part, ctx.home)
            total = part if total is None else total + part
        return total, None, None


def replicate_groups(devices: Sequence[torch.device], home: torch.device,
                     order: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """The groups of :class:`Replicate` for outputs on ``devices`` added
    in ``order``: each output alone where it lies on ``home`` (the order
    kept element by element), a run of consecutive outputs on one other
    device as one group (their sum crosses once)."""
    groups: List[List[int]] = []
    for i in order:
        dev = devices[i]
        if groups and dev != home and devices[groups[-1][-1]] == dev:
            groups[-1].append(i)
        else:
            groups.append([i])
    return tuple(tuple(g) for g in groups)


def replicate(t: torch.Tensor, devices: Sequence[torch.device],
              order: Optional[Sequence[int]] = None
              ) -> Tuple[torch.Tensor, ...]:
    """``t`` on each of ``devices`` (:class:`Replicate`), the cotangents
    added in ``order`` (default: the order of ``devices``)."""
    devices = tuple(norm_device(d) for d in devices)
    order = range(len(devices)) if order is None else order
    return Replicate.apply(t, devices,
                           replicate_groups(devices, t.device, order))


@dataclasses.dataclass(frozen=True)
class NodeRows:
    """A node-major array on a mesh: ``parts[j]``, the rows of this
    process's shard ``j`` (global shard ``mesh.first_shard + j``), ``[n_per,
    ...]`` on that shard's device, one tensor per shard. The port's
    counterpart of a JAX array placed with ``node_sharding``."""

    parts: Tuple[torch.Tensor, ...]

    def __post_init__(self):
        parts = tuple(self.parts)
        object.__setattr__(self, "parts", parts)
        if not parts:
            raise ValueError("NodeRows needs at least one shard")
        shape, dtype = parts[0].shape, parts[0].dtype
        for p in parts:
            if p.shape != shape or p.dtype != dtype:
                got = [(tuple(q.shape), q.dtype) for q in parts]
                raise ValueError("every shard's rows have one shape and "
                                 f"dtype, got {got}")

    def __len__(self) -> int:
        return len(self.parts)

    def __iter__(self) -> Iterator[torch.Tensor]:
        return iter(self.parts)

    @property
    def n_per(self) -> int:
        return self.parts[0].shape[0]

    @property
    def num_rows(self) -> int:
        """This process's rows, ``k * n_per``."""
        return len(self.parts) * self.n_per

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(p.device for p in self.parts)

    def map(self, fn) -> "NodeRows":
        """``fn`` applied to each shard's rows (ReLU, a cast)."""
        return NodeRows(tuple(fn(p) for p in self.parts))

    def check(self, mesh: Mesh) -> None:
        """Raise unless the rows are this process's shards of ``mesh``,
        each on its shard's device."""
        if len(self.parts) != mesh.local_size:
            raise ValueError(f"{len(self.parts)} shards of rows, the mesh has "
                             f"{mesh.local_size} in this process")
        for j, (p, dev) in enumerate(zip(self.parts, mesh.devices)):
            if p.device != norm_device(dev):
                raise ValueError(f"shard {mesh.first_shard + j}'s rows lie on "
                                 f"{p.device}, its shard's device is {dev}")

    def gather(self, device=None) -> torch.Tensor:
        """The rows in shard order ``[k * n_per, ...]`` on ``device``
        (default: the first shard's), under autograd."""
        device = self.parts[0].device if device is None else device
        return torch.cat([move(p, device) for p in self.parts])

    def numpy(self) -> np.ndarray:
        """The rows in shard order on the host (no autograd)."""
        return np.concatenate([p.detach().cpu().numpy() for p in self.parts])

    def as_parameters(self) -> "NodeRows":
        """One ``nn.Parameter`` per shard (the per-shard embedding)."""
        return NodeRows(tuple(torch.nn.Parameter(p.detach())
                              for p in self.parts))


def pad_node_array(x, edges):
    """The leading (node) axis padded with zero rows to ``S * n_per``
    (``edges``: a halo partition, anything with ``n_per`` and
    ``num_shards``), as the JAX ``pad_node_array``; numpy or torch."""
    extra = edges.n_per * edges.num_shards - x.shape[0]
    if extra <= 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((extra, *x.shape[1:]))])
    x = np.asarray(x)
    return np.pad(x, ((0, extra),) + ((0, 0),) * (x.ndim - 1))


def put_global(host_array, mesh: Mesh) -> NodeRows:
    """A node-major host array ``[S * n_per, ...]`` (numpy or a CPU
    tensor) -> this process's shards (:class:`NodeRows`), each shard's
    rows copied to its device: the JAX package's ``put_global(a,
    node_sharding(mesh))``, also under that name (:func:`node_sharding`)."""
    if isinstance(host_array, torch.Tensor):
        host_array = host_array.detach().cpu().numpy()
    rows = process_rows(host_array, mesh)
    n_per = rows.shape[0] // mesh.local_size
    return NodeRows(tuple(
        torch.tensor(rows[j * n_per:(j + 1) * n_per], device=dev)
        for j, dev in enumerate(mesh.devices)))


# the JAX package places node-major arrays with put_global(a,
# node_sharding(mesh)); the port's placement is that one call
node_sharding = put_global


def shard_rows(x: torch.Tensor, mesh: Mesh) -> NodeRows:
    """This process's rows ``x [k * n_per, ...]`` (one tensor, any
    device) -> its shards, each moved to its shard's device under
    autograd: the conversion at the edge of a caller that keeps one
    tensor (``Trainer``)."""
    k = mesh.local_size
    if x.shape[0] % k:
        raise ValueError(f"{x.shape[0]} rows do not split over {k} shards")
    n_per = x.shape[0] // k
    return NodeRows(tuple(move(x[j * n_per:(j + 1) * n_per], dev)
                          for j, dev in enumerate(mesh.devices)))


@dataclasses.dataclass(frozen=True)
class RowPick:
    """Given rows of a :class:`NodeRows`, in their given order, onto one
    device: ``local[j]``, the rows shard ``j`` owns (its row ids, on its
    device, in the given order; empty where it owns none), ``order`` the
    permutation of the shards' picks back into the given order (None: it
    is the identity) and ``device``. Made once by :func:`row_pick`, so a
    step reads no index from the host. Every shard's pick, an empty one
    too, stays on the result's autograd path, so every shard's rows get a
    cotangent (zeros where none was picked), as the transpose of the JAX
    ``logits[idx]`` gives one to every shard."""

    local: Tuple[torch.Tensor, ...]
    order: Optional[torch.Tensor]
    device: torch.device
    count: int

    def take(self, x: NodeRows) -> torch.Tensor:
        """``x``'s picked rows ``[count, ...]`` on ``device``, under
        autograd: each shard's own, gathered there, moved, put in order."""
        if len(x.parts) != len(self.local):
            raise ValueError(f"a pick over {len(self.local)} shards, rows of "
                             f"{len(x.parts)}")
        picked = [move(p.index_select(0, idx), self.device)
                  for p, idx in zip(x.parts, self.local)]
        out = torch.cat(picked) if len(picked) > 1 else picked[0]
        return out if self.order is None else out.index_select(0, self.order)


def row_pick(rows, n_per: int, devices: Sequence[torch.device],
             device=None) -> RowPick:
    """The :class:`RowPick` of ``rows`` (ids into this process's rows
    ``[0, k * n_per)``, host ints) over shards of ``n_per`` rows on
    ``devices``, onto ``device`` (default: the first shard's)."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    k = len(devices)
    if rows.size and (rows.min() < 0 or rows.max() >= k * n_per):
        raise ValueError(f"rows outside [0, {k * n_per})")
    owner = rows // n_per
    local, where = [], []
    for j, dev in enumerate(devices):
        mine = np.flatnonzero(owner == j)
        where.append(mine)
        local.append(torch.as_tensor(rows[mine] - j * n_per).to(
            norm_device(dev)))
    pos = np.concatenate(where) if where else np.zeros(0, np.int64)
    order = None if np.array_equal(pos, np.arange(rows.size)) else \
        torch.as_tensor(np.argsort(pos, kind="stable"))
    device = norm_device(devices[0] if device is None else device)
    return RowPick(tuple(local), None if order is None else order.to(device),
                   device, int(rows.size))


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
