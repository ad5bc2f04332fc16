"""CUDA IPC between the processes of a mesh: kernels #6 and #7 read other
processes' rows where they lie.

Within one process the halo kernels read every shard through a table of
device pointers (``csrc/span_rows.cuh`` ``PtrTable``). Across processes a
peer's rows reach that table through CUDA IPC. ``cudaIpcGetMemHandle``
wants the base of a ``cudaMalloc`` allocation, which PyTorch's caching
allocator does not give (it sub-allocates, and under
``expandable_segments`` does not call ``cudaMalloc`` at all), so the rows a
process shares live in buffers that the halo library allocates itself
(``csrc/halo_kernels.cu`` ``ipc_alloc``): one :class:`PeerSet` per
(rows, width, dtype) on a mesh, made once, whose memory and event handles
the processes exchange once, through the process group's
``all_gather_object``, never per call. A call copies this process's rows
into its buffer; the kernels read the peers' buffers through
:class:`PeerRows`, which stand in the pointer table for a peer's shards.
No copy over the host stands in when IPC or peer access is missing: the
open raises.

The order of the streams within a process becomes an order between
processes, with two interprocess events a process
(``cudaEventInterprocess``) and host barriers over the group:

- :meth:`PeerSet.publish`: the stream waits for every peer's ``read``
  event (the peers' last reads of this buffer are done), copies the rows
  in and records ``written``; a host barrier (every ``written`` is
  recorded); the stream waits for every peer's ``written`` event;
- the launches that read the peers' rows;
- :meth:`PeerSet.release`: the stream records ``read``; a host barrier,
  so that no process writes its buffer again before every reader has
  recorded its ``read``.

``parallel/mesh.py`` ``BARRIER`` counts and times the two host barriers
of a call; flags in device memory in their place are later work. The
buffers are CUDA memory outside PyTorch's allocator, so ``torch.cuda``
memory statistics do not count them: :func:`shared_bytes` does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.parallel.mesh import (
    Mesh, gather_objects, host_barrier)

HANDLE_BYTES = 64


class PeerRows:
    """A shard's rows in another process, mapped on ``device``:
    what the halo wrappers read of a source (shape, dtype, device,
    address), with no tensor behind it. On this process's device, so the
    wrappers' stream order and peer access leave it to :class:`PeerSet`."""

    def __init__(self, ptr: int, shape: Sequence[int], dtype: torch.dtype,
                 device: torch.device):
        self.ptr = ptr
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = device

    def data_ptr(self) -> int:
        return self.ptr

    def numel(self) -> int:
        return self.shape.numel()

    def is_contiguous(self) -> bool:
        return True

    def element_size(self) -> int:
        return torch.empty(0, dtype=self.dtype).element_size()


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    cuda_build.check_launch(lib, err, f"CUDA IPC {what}")


class PeerSet:
    """This process's shared buffer of its k shards' ``shape`` rows of
    ``dtype`` on the mesh's device, its two events, and every peer's,
    mapped here."""

    def __init__(self, lib: ctypes.CDLL, mesh: Mesh, shape: Sequence[int],
                 dtype: torch.dtype):
        dev = mesh.first
        if dev.type != "cuda":
            raise ValueError(f"CUDA IPC needs a card, got {dev}")
        self.lib, self.mesh, self.device = lib, mesh, dev
        self.shape = torch.Size(shape)
        self.slot_bytes = self.shape.numel() * torch.empty(
            0, dtype=dtype).element_size()
        self.nbytes = mesh.local_size * self.slot_bytes
        me = mesh.process_index
        with torch.cuda.device(dev):
            self.ptr = ctypes.c_void_p()
            handle = ctypes.create_string_buffer(HANDLE_BYTES)
            _check(lib, lib.ipc_alloc(max(self.nbytes, 1),
                                      ctypes.byref(self.ptr), handle),
                   f"alloc of {self.nbytes} bytes")
            self.events = {}
            handles = {"mem": handle.raw}
            for name in ("written", "read"):
                ev = ctypes.c_void_p()
                h = ctypes.create_string_buffer(HANDLE_BYTES)
                _check(lib, lib.ipc_event_create(ctypes.byref(ev), h),
                       "event")
                self.events[name] = ev
                handles[name] = h.raw
            infos = gather_objects(handles, mesh)
            self.peer_ptrs: Dict[int, ctypes.c_void_p] = {}
            self.peer_events: Dict[str, List[ctypes.c_void_p]] = {
                "written": [], "read": []}
            for r, info in enumerate(infos):
                if r == me:
                    continue
                ptr = ctypes.c_void_p()
                _check(lib, lib.ipc_open(info["mem"], ctypes.byref(ptr)),
                       f"open of process {r}'s buffer on {dev} (no IPC or no "
                       "peer access: the cross-process kernels need it)")
                self.peer_ptrs[r] = ptr
                for name in ("written", "read"):
                    ev = ctypes.c_void_p()
                    _check(lib, lib.ipc_event_open(info[name],
                                                   ctypes.byref(ev)),
                           f"open of process {r}'s {name} event")
                    self.peer_events[name].append(ev)
        k = mesh.local_size
        self.peer_rows = {
            r * k + j: PeerRows(ptr.value + j * self.slot_bytes, self.shape,
                                dtype, dev)
            for r, ptr in self.peer_ptrs.items() for j in range(k)}

    def publish(self, rows: Sequence[torch.Tensor]) -> List:
        """Copy this process's k shards' ``rows`` into its buffer, in
        order between the processes; returns the S sources of the mesh in
        shard order: ``rows`` for this process's shards, :class:`PeerRows`
        for the others'. Call :meth:`release` after the launches that read
        them."""
        mesh, lib = self.mesh, self.lib
        if len(rows) != mesh.local_size or any(
                t.shape != self.shape or t.device != self.device
                for t in rows):
            raise ValueError(f"publish takes {mesh.local_size} x "
                             f"{tuple(self.shape)} on {self.device}")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            for ev in self.peer_events["read"]:
                _check(lib, lib.stream_wait_event(stream, ev), "wait")
            for j, t in enumerate(rows):
                _check(lib, lib.copy_async(
                    self.ptr.value + j * self.slot_bytes,
                    t.contiguous().data_ptr(), self.slot_bytes, stream),
                    "copy")
            _check(lib, lib.event_record(self.events["written"], stream),
                   "record")
        host_barrier(mesh)
        with torch.cuda.device(self.device):
            for ev in self.peer_events["written"]:
                _check(lib, lib.stream_wait_event(stream, ev), "wait")
        first = mesh.first_shard
        return [rows[g - first] if first <= g < first + mesh.local_size
                else self.peer_rows[g] for g in range(mesh.size)]

    def release(self) -> None:
        """After the launches that read the peers' rows: record ``read``,
        then wait for every process."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            _check(self.lib, self.lib.event_record(self.events["read"],
                                                   stream), "record")
        host_barrier(self.mesh)

    def close_peers(self) -> None:
        """Unmap the peers' buffers and events (every process, before any
        frees its own)."""
        with torch.cuda.device(self.device):
            for ptr in self.peer_ptrs.values():
                _check(self.lib, self.lib.ipc_close(ptr), "close")
            for evs in self.peer_events.values():
                for ev in evs:
                    _check(self.lib, self.lib.event_destroy(ev), "close")
        self.peer_ptrs, self.peer_rows = {}, {}
        self.peer_events = {"written": [], "read": []}

    def free(self) -> None:
        with torch.cuda.device(self.device):
            _check(self.lib, self.lib.ipc_free(self.ptr), "free")
            for ev in self.events.values():
                _check(self.lib, self.lib.event_destroy(ev), "free")


def peer_set(lib: ctypes.CDLL, mesh: Mesh, shape: Sequence[int],
             dtype: torch.dtype) -> PeerSet:
    """The mesh's :class:`PeerSet` of ``shape`` rows of ``dtype``, made at
    its first use (by every process at once: it exchanges handles)."""
    key = (tuple(shape), dtype)
    if key not in mesh.peer_sets:
        mesh.peer_sets[key] = PeerSet(lib, mesh, shape, dtype)
    return mesh.peer_sets[key]


def shared_bytes(mesh: Mesh) -> int:
    """Bytes of this process's IPC buffers on the mesh."""
    return sum(s.nbytes for s in mesh.peer_sets.values())


def close_peer_sets(mesh: Mesh) -> None:
    """Unmap every peer's buffers, wait for every process, then free this
    process's own; every process of the mesh calls it."""
    sets = list(mesh.peer_sets.values())
    if not sets:
        return
    torch.cuda.synchronize(mesh.first)
    for s in sets:
        s.close_peers()
    host_barrier(mesh)
    for s in sets:
        s.free()
    mesh.peer_sets.clear()
