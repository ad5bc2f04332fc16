"""The halo exchange: an all-to-all of ``[S, H, d]`` boundary blocks.

``out[q][p] = send[p][q]``: shard ``q`` receives from every shard ``p`` the
block ``p`` prepared for it (its own block included), as
``lax.all_to_all(send, axis, 0, 0)`` does inside the JAX package's
``shard_map``. Three implementations, one contract:

- :func:`halo_exchange` (kernel #6): the hand-written pull kernel
  (``csrc/halo_kernels.cu`` ``halo_pull``), which replaces the TPU
  remote-DMA kernel ``scaling_rgcn_training_tpu/parallel/ring_halo.py:42``
  ``_a2a_kernel``. One launch per receiver, on the receiver's stream,
  reads the S senders' blocks through a table of their pointers; within a
  process the order of the streams replaces the TPU kernel's barrier
  semaphore. On the CPU it runs its plain version;
- :func:`halo_exchange_plain`: the plain version, one ``copy_`` per block;
- :func:`halo_exchange_library`: the default exchange of the halo conv,
  PyTorch's own copies (``Tensor.to``, a peer copy between cards, and one
  ``torch.stack`` per receiver): the counterpart of ``lax.all_to_all``.

Both count the bytes they move between two cards of this process in
``parallel/mesh.py`` ``CROSS_CARD`` (#6: the blocks a receiver pulls from
another card).

:class:`HaloExchange` makes either exchange differentiable: the exchange
is its own transpose (exchanging twice restores the layout), so its
gradient is the exchange of the cotangents, as in the JAX package. On the
cards it runs on each card's exchange stream (:func:`exchange_stream`,
:class:`Overlap`), both ways, so that ``parallel/halo.py`` can run the
owner-local aggregation on the compute streams while the halo rows are in
flight. :func:`send_transpose` is the transpose of the gather that fills a
shard's sends, shared by both halo backwards (``parallel/halo.py``, and
kernel #7's in ``parallel/fused_halo.py``).

The shards' devices may be S cards, or S virtual shards on one card (a
mesh that repeats one device). Between cards the kernels read peer memory:
the wrappers check ``torch.cuda.can_device_access_peer`` and raise without
it, then enable peer access once per pair.

Across processes (a ``mesh`` of several, ``parallel/mesh.py``) each
process passes its k shards' sends and gets its k receivers' blocks. The
library exchange moves the blocks between processes in one
``all_to_all_single`` over the process group (the counterpart of
``lax.all_to_all`` crossing DCN in the JAX package; blocks between shards
of one process stay local copies). Kernel #6 runs unchanged over a table
that mixes this process's sends with other processes' send blocks mapped
by CUDA IPC (``parallel/ipc.py``, which also orders the processes'
streams). On the CPU every mode takes the library exchange between
processes.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from scaling_rgcn_training_tpu_torch.ops import cuda_build
from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
from scaling_rgcn_training_tpu_torch.ops.segment_kernels import (
    sorted_segment_sum)
from scaling_rgcn_training_tpu_torch.parallel.ipc import peer_set
from scaling_rgcn_training_tpu_torch.parallel.mesh import (
    CROSS_CARD, Mesh, all_to_all_rows, copy_to)

# shards the kernels' pointer tables hold (csrc/span_rows.cuh kMaxShards)
MAX_SHARDS = 64


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.enable_peer.argtypes = [i]
    lib.enable_peer.restype = i
    lib.halo_pull.argtypes = [p, i, p, i, ctypes.c_longlong, p]
    lib.halo_pull.restype = i
    lib.fused_halo_rows.argtypes = [i, p, i, i, p, p, p, p, p, p, i, i, i, i,
                                    p, p, i, p]
    lib.fused_halo_rows.restype = i
    lib.fused_halo_tc.argtypes = [i, p, i, i, *[p] * 10, i, i, i, i, i, p, p,
                                  i, p]
    lib.fused_halo_tc.restype = i
    pp, b, ll = ctypes.POINTER(p), ctypes.c_char_p, ctypes.c_longlong
    for name, args in (("ipc_alloc", [ll, pp, b]), ("ipc_free", [p]),
                       ("ipc_open", [b, pp]), ("ipc_close", [p]),
                       ("ipc_event_create", [pp, b]),
                       ("ipc_event_open", [b, pp]), ("event_destroy", [p]),
                       ("event_record", [p, p]),
                       ("stream_wait_event", [p, p]),
                       ("copy_async", [p, p, ll, p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i


def halo_kernels() -> ctypes.CDLL:
    return cuda_build.load("halo_kernels", _declare)


def on_cards(tensors: Sequence[torch.Tensor]) -> bool:
    """True when every tensor lies on a CUDA device (one or several),
    False when all lie on the CPU; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"}:
        raise ValueError("halo kernels need every tensor on CUDA devices (or "
                         f"all on the CPU), got {sorted(kinds)}")
    return True


def pointer_table(tensors: Sequence[torch.Tensor]):
    """The tensors' device pointers as a C array of ``void*``."""
    if len(tensors) > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards, got {len(tensors)}")
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


_peer_enabled = set()


def connect(lib: ctypes.CDLL, reader: torch.device,
            sources: Sequence[torch.Tensor]) -> None:
    """Let ``reader`` read every source's card; raises when the hardware
    gives no peer access (no fallback to copies)."""
    for t in sources:
        peer = t.device
        if peer == reader or (reader.index, peer.index) in _peer_enabled:
            continue
        if not torch.cuda.can_device_access_peer(reader, peer):
            raise RuntimeError(f"{reader} cannot read {peer}'s memory (no "
                               "peer access): the halo kernels need it")
        with torch.cuda.device(reader):
            cuda_build.check_launch(lib, lib.enable_peer(peer.index),
                                    f"peer access {reader} -> {peer}")
        _peer_enabled.add((reader.index, peer.index))


def wait_for_sources(stream: torch.cuda.Stream,
                     sources: Sequence[torch.Tensor]) -> None:
    """``stream`` waits for the work queued on every other card that
    produces a source."""
    for dev in {t.device for t in sources} - {stream.device}:
        stream.wait_stream(torch.cuda.current_stream(dev))


def release_sources(stream: torch.cuda.Stream,
                    sources: Sequence[torch.Tensor]) -> None:
    """After a launch on ``stream`` that reads the sources: the other
    cards' streams wait for it, and the caching allocator keeps each
    source's memory until it is done."""
    for dev in {t.device for t in sources} - {stream.device}:
        torch.cuda.current_stream(dev).wait_stream(stream)
    for t in sources:
        if t.device != stream.device:
            t.record_stream(stream)


def _across(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.multiprocess


def _check(sends: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> None:
    """S sends of ``[S, H, d]``; across processes this process's k."""
    s_n = mesh.size if _across(mesh) else len(sends)
    if len(sends) < 1 or (_across(mesh) and len(sends) != mesh.local_size):
        raise ValueError(f"an exchange takes this process's shards' sends, "
                         f"got {len(sends)}")
    shape, dtype = sends[0].shape, sends[0].dtype
    for t in sends:
        if t.dim() != 3 or t.shape != shape or t.shape[0] != s_n:
            raise ValueError(f"each send must be [S={s_n}, H, d] of one "
                             f"shape, got {[tuple(t.shape) for t in sends]}")
        if t.dtype != dtype:
            raise TypeError(f"mixed dtypes {dtype} and {t.dtype}")


def exchange_across(sends: Sequence[torch.Tensor],
                    mesh: Mesh) -> List[torch.Tensor]:
    """The library exchange between processes: this process's k sends
    ``[S, H, d]`` -> its k receivers' ``[S, H, d]``, the blocks of each
    other process in one ``all_to_all_single`` (``all_to_all_rows``),
    this process's own as local copies."""
    k, p_n = mesh.local_size, mesh.process_count
    h, d = sends[0].shape[1:]
    # [P (to), k (local sender), k (receiver in that process), H, d]
    blocks = torch.stack(list(sends)).view(k, p_n, k, h, d).transpose(0, 1)
    got = all_to_all_rows(blocks, mesh)   # [P (from), k (sender), k (me)]
    return list(got.permute(2, 0, 1, 3, 4).reshape(k, p_n * k, h, d))


def halo_exchange_plain(sends: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Kernel #6's plain version: ``out[q][p].copy_(send[p][q])``."""
    _check(sends)
    outs = [torch.empty_like(t) for t in sends]
    for q, out in enumerate(outs):
        for p, send in enumerate(sends):
            out[p].copy_(send[q])
    return outs


def halo_exchange_library(sends: Sequence[torch.Tensor],
                          mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """The default exchange: per receiver, the S blocks moved to its
    device (``Tensor.to``: a peer copy between cards, nothing on one card)
    and stacked; across processes :func:`exchange_across`."""
    _check(sends, mesh)
    if _across(mesh):
        return exchange_across(sends, mesh)
    return [torch.stack([copy_to(send[q], sends[q].device) for send in sends])
            for q in range(len(sends))]


def halo_exchange(sends: Sequence[torch.Tensor],
                  mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """Kernel #6: ``sends[p] [S, H, d]`` on shard ``p``'s device ->
    ``outs[q] [S, H, d]`` on shard ``q``'s, ``outs[q][p] = sends[p][q]``;
    float32 or bfloat16, any H and d. Across processes (``mesh``): this
    process's k sends -> its k receivers' blocks, the other processes'
    send blocks read through CUDA IPC; on the CPU the library exchange
    between processes."""
    _check(sends, mesh)
    if not on_cards(sends):
        if _across(mesh):
            return exchange_across(sends, mesh)
        return halo_exchange_plain(sends)
    if sends[0].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"halo_exchange takes float32 or bfloat16, got "
                        f"{sends[0].dtype}")
    sends = [t.contiguous() for t in sends]
    outs = [torch.empty_like(t) for t in sends]
    block_bytes = sends[0][0].numel() * sends[0].element_size()
    if block_bytes == 0:
        return outs
    lib = halo_kernels()
    peers, sources, first = None, sends, 0
    if _across(mesh):
        peers = peer_set(lib, mesh, sends[0].shape, sends[0].dtype)
        sources, first = peers.publish(sends), mesh.first_shard
    table = pointer_table(sources)
    for j, out in enumerate(outs):
        dev = out.device
        connect(lib, dev, sources)
        stream = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev):
            wait_for_sources(stream, sources)
            err = lib.halo_pull(table, len(sources), out.data_ptr(),
                                first + j, block_bytes, stream.cuda_stream)
            cuda_build.check_launch(lib, err, "halo_exchange")
            release_sources(stream, sources)
        # the blocks it pulled from another card of this process
        CROSS_CARD["bytes"] += block_bytes * sum(
            t.device != dev for t in sends)
    if peers is not None:
        peers.release()
    LAUNCHES["halo_exchange"] += 1
    return outs


EXCHANGES = {"library": halo_exchange_library, "kernel": halo_exchange}


def send_transpose(g_send: torch.Tensor, shard) -> torch.Tensor:
    """The transpose of ``x_own[shard.send_idx]``: ``[n_per, d]`` float32,
    row ``i`` the sum of the rows of ``g_send [S * H, d]`` that
    ``send_idx`` took from row ``i``, through the CSR of a
    ``parallel/halo.py`` ``HaloShard`` (``send_perm``, ``send_rowptr``;
    the padding slots, whose cotangents are zero, left out), in a fixed
    order: kernel #3 on the card, so two runs give the same bits."""
    return sorted_segment_sum(g_send.contiguous(), shard.send_rowptr,
                              perm=shard.send_perm)


# each card's exchange stream, made at its first use (exchange_stream)
_EXCHANGE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def exchange_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream the halo exchange runs on, one per card for the
    process, made at its first use; raises where no stream can be made."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = _EXCHANGE_STREAMS.get(index)
    if stream is None:
        stream = _EXCHANGE_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


@dataclasses.dataclass(frozen=True)
class Overlap:
    """The streams of one halo exchange on the cards of a mesh:
    ``compute[dev]``, each card's stream current at the call (the send
    gathers and both aggregation segments run there), ``exchange[dev]``,
    its exchange stream (:func:`exchange_stream`), and ``blocked``
    (``RGCN_HALO_BLOCK_OVERLAP``: the join before the owner-local work, as
    the JAX package's ``optimization_barrier``, in both directions)."""

    compute: Dict[torch.device, torch.cuda.Stream]
    exchange: Dict[torch.device, torch.cuda.Stream]
    blocked: bool

    @classmethod
    def on(cls, devices: Sequence[torch.device], blocked: bool) -> "Overlap":
        """The streams of ``devices``; raises where a card's current stream
        is its exchange stream (nothing could overlap)."""
        devs = list(dict.fromkeys(devices))
        ov = cls({d: torch.cuda.current_stream(d) for d in devs},
                 {d: exchange_stream(d) for d in devs}, blocked)
        for dev, ex in ov.exchange.items():
            if ov.compute[dev] == ex:
                raise RuntimeError(f"the current stream of {dev} is its "
                                   "halo exchange stream")
        return ov

    @contextlib.contextmanager
    def issue(self, *after: Dict[torch.device, torch.cuda.Stream]
              ) -> Iterator[None]:
        """Each card's exchange stream waits for the work queued so far on
        its streams in ``after`` (default: its compute stream), then is the
        card's current stream inside the block."""
        with contextlib.ExitStack() as stack:
            for dev, ex in self.exchange.items():
                for streams in after or (self.compute,):
                    if streams[dev] != ex:
                        ex.wait_stream(streams[dev])
                stack.enter_context(torch.cuda.stream(ex))
            yield

    def join(self, into: Optional[Dict[torch.device, torch.cuda.Stream]]
             = None) -> None:
        """Each card's stream in ``into`` (default: its compute stream)
        waits for its exchange stream."""
        for dev, ex in self.exchange.items():
            stream = (into or self.compute)[dev]
            if stream != ex:
                stream.wait_stream(ex)


class HaloExchange(torch.autograd.Function):
    """``EXCHANGES[mode]`` over this process's sends on ``mesh`` (None:
    one process); its gradient is the same exchange of the cotangents.

    With an :class:`Overlap` (the cards) the caller applies it inside
    ``overlap.issue()``, right after the send gathers: the exchange runs
    on the exchange streams once the sends are written, the
    received buffers come back there unjoined, and autograd records the
    exchange streams as this node's, so the engine makes them wait for the
    cotangents' producers as each arrives and makes the send gathers'
    backwards wait for the reverse exchange. The backward runs the reverse
    exchange on every card's exchange stream (the engine sets one card's
    stream only); in the blocked arm it first waits for the compute
    streams, so the reverse exchange follows the owner-local backward.
    Tensors read on the other stream are recorded there for the caching
    allocator."""

    @staticmethod
    def forward(ctx, mode: str, mesh: Optional[Mesh],
                overlap: Optional[Overlap], *sends):
        ctx.mode, ctx.mesh, ctx.overlap = mode, mesh, overlap
        recvs = EXCHANGES[mode](sends, mesh)
        if overlap is not None:
            for t in sends:
                t.record_stream(overlap.exchange[t.device])
            for t in recvs:
                t.record_stream(overlap.compute[t.device])
        return tuple(recvs)

    @staticmethod
    def backward(ctx, *grads):
        ov = ctx.overlap
        if ov is None:
            return (None, None, None, *EXCHANGES[ctx.mode](
                [g.contiguous() for g in grads], ctx.mesh))
        # the streams the engine runs this node on: the exchange stream of
        # one card, the current (accumulating) stream of the others
        current = {d: torch.cuda.current_stream(d) for d in ov.exchange}
        with ov.issue(current, *((ov.compute,) if ov.blocked else ())):
            outs = EXCHANGES[ctx.mode]([g.contiguous() for g in grads],
                                       ctx.mesh)
        for g in grads:
            g.record_stream(ov.exchange[g.device])
        for t in outs:
            t.record_stream(ov.compute[t.device])
        ov.join(current)
        return (None, None, None, *outs)
