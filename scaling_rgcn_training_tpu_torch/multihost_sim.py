"""Training across processes, in the halo partition or the edge
partition: P processes x k shards against the single-process run of the
same S = P * k shards.

Counterpart of the JAX package's ``scripts/multihost_sim.py``:

    python -m scaling_rgcn_training_tpu_torch.multihost_sim \\
        [--device cpu|cuda] [--procs P] [--shards-per-proc k] [--cards C] \\
        [--modes library,kernel,fused-bf16,edge-f32,...] [--widths D,HL,C] \\
        [--check] [--time-calls] [--ckpt DIR] [--workdir DIR]

The parent makes the graph from numpy seed 0 as the JAX script does
(``src``, ``dst`` uniform over N, the relation over 2R; locality reorder
with ``MH_REORDER``), builds the partitions the modes need once, S shards
each, into a plan cache in its work directory (the halo partition,
``pad_to_multiple=64``; the edge partition, ``shard_rel_edges``' default
512), runs the single-process S-shard run of each mode (the oracle), then
spawns P children (``--child r``). Each joins the process group
(``parallel/mesh.py`` ``initialize_multihost``: gloo on the CPU and when
the processes share a card, NCCL with a card each; the rendezvous is
``tcp://localhost:MH_PORT`` with ``MH_PORT`` set, else a file in the work
directory), loads the partitions from the plan cache and runs the same
loop with its k shards, the partition's collectives crossing the
processes. The parent prints one JSON line: per mode both loss series and
``loss_parity`` (float32 ``np.allclose(rtol=1e-5, atol=1e-6)``, the JAX
script's; bfloat16 streams ``rtol=5e-3`` with ``atol`` 5e-3 of the first
loss: as the loop learns the labels the loss falls ~1000x, and a bf16
rounding that the float32 sums' other order flips moves a loss of 0.002
by a few percent while the difference stays ~1e-4 of the first loss; in
the edge partition also the first loss with the one-process run's bits,
since the forward adds the shards' partials in the same order, and
``loss_series_same_bits`` says whether every loss kept them: the backward
adds the shards' cotangents in one order in both layouts), whether
every process ended with the same bits of every replicated tensor and
Adam moment (``replicated_bits_equal``), ms/step, peak memory and each
process's kernel launches a step (the edge partition: also the MB each
process contributes to the cross-process sums a step) and ``step``, the
route of the step: ``"eager"``, always (across processes a step is not
captured as a CUDA graph, ``train/step_graph.py``), and exits 1 unless
every mode matches. A child that fails, or that is still running at
``--timeout`` (a collective one process never entered), makes the run
raise; the others are killed.

The loop: embedding -> conv -> ReLU -> conv -> BCE over the labelled rows
-> Adam 0.05 (no L2), the parameters drawn with
``np.random.default_rng`` (seed 1; the layers as ``init_rgcn_layer``
draws them). The labelled rows (``MH_LABELLED``, 128 as in the JAX
script) are spread evenly over the graph (the JAX script takes the first
128, which all lie on process 0).

- Halo partition (``library``, ``kernel``, ``fused``): the embedding
  ``[S * n_per, D]`` is node-sharded (``parallel/mesh.py``
  ``node_sharding``: one Parameter a shard of the process, so Adam's
  moments lie with the rows), the conv is ``halo_rgcn_conv``. Each shard
  picks the labelled rows it owns (``mesh.RowPick``). A process's loss is
  the sum over its labelled rows, summed over the
  processes in rank order and divided by the global count; the layers'
  gradients are summed across processes (``mesh.sum_replicated_grads``).
- Edge partition (``edge``): the embedding ``[N, D]`` is replicated, the
  conv is ``parallel/spmd.py`` ``sharded_rgcn_conv`` with the kernels'
  grouped matmul (``backend="pallas"``: #4, #3 and #5 on every process's
  shards). Every process takes every labelled row; the loss is the
  replicated mean. Only the aggregation's partial sums and cotangents
  cross the processes (``spmd.SumShards``, ``spmd.ShardInputs``): each
  process's per-shard partials forward and per-shard cotangents backward
  are gathered and added in global shard order, as one process adds
  them. The root term, the loss and Adam run on whole replicated
  tensors, so their gradients are not summed again.

``--modes``: ``library``, ``kernel`` (#6), ``fused`` (#7) or ``edge``,
each with ``-f32`` or ``-bf16`` for its edge streams (default
``MH_BF16``); by default the one halo mode ``RGCN_HALO_PALLAS_A2A``
picks, as in the JAX package. On the card every child must launch each of
its mode's kernels the expected number of times on every step (halo: #1
and #2, #3 for the send transposes, #6 or #7; edge: #4, #3, #5) and no
other counted kernel, or it fails.

``--check``: for the halo modes each child holds the library exchange,
#6 and #7 across processes against the single-process plain versions on
the whole data (the exchanges and the halo buffers bit for bit, #7's sums
within f32 1e-4 / bf16 2e-2 of max|ref|; two runs the same bits) at S = P
and 2P over graphs where a shard has no halo edges and (from 3 shards) a
peer ships no rows, float32 and bfloat16; for the edge mode, one layer's
aggregation across processes (the summed output and the ``x`` and ``w``
cotangents) against the one-process ``sharded_aggregate`` of every shard
on the same data, at S = P and 2P, on a random graph and on 600 edges cut
into shards of 512 (from 3 shards the last shards hold only padding
rows), float32 and bfloat16: all three bit for bit.
``--time-calls`` (card): each exchange and #7 per call at
layer 1's width across processes, and by the parent in one process,
beside their bounds (``fused_halo_cost`` with the ``x_own`` copy), the
whole aggregation's forward with the library exchange and with #6, each
with the exchange overlapping the owner-local segment and blocked
(``RGCN_HALO_BLOCK_OVERLAP``), and the host barrier alone; for the edge
mode the sums of a layer-1 forward (the shards' partials ``[N, HL]``) and
of its backward (the shards' ``[N, D]`` and ``w`` cotangents) per call,
across processes beside the
bytes a process contributes and receives, and in one process over its S
shards. ``--ckpt DIR``: each
mode's state before its first step and after its last written through
``utils/checkpoint.py`` by both layouts (``{single,multi}-{mode}-{step0,
final}.npz``; the edge mode's state is replicated, so each child writes
its own, ``multi-{mode}-{tag}-rank{r}.npz``); every child reads its files
back and checks them, and the parent reads the multi step-0 files into
one process and checks their bits against its own.

Knobs, as the JAX script's: ``MH_NODES`` (2048), ``MH_EDGES`` (16384),
``MH_RELS`` (5), ``MH_STEPS`` (5), ``MH_BF16`` (1), ``MH_REORDER`` (1),
``MH_PORT``; and ``MH_LABELLED`` (128): at the bench shape the loop
learns 128 rows' labels within 3 steps (loss ~1e-5 by step 6, where a
relative comparison of the two layouts' losses is noise), so
``chip_smoke.py`` labels 4,096.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

LR = 0.05
CHILD_TAG = "MH_CHILD "
# the halo exchange RGCN_HALO_PALLAS_A2A selects for each mode (the edge
# partition exchanges no halo)
MODES = {"library": None, "kernel": "1", "fused": "fused", "edge": None}
# per step and shard of a process: (halo forward) the local and halo span
# forwards of both layers, (backward) their span backwards and the send
# gathers' transposes (#3); #6 per exchange call, #7 per shard and layer;
# (edge) #4 and #3 for both layers' messages and sums, then each layer's
# d_lhs, dx sum and d_rhs (the embedding takes a gradient)
EXPECTED = {
    "library": {"span_forward": 4, "span_backward": 4, "segment_sum": 2},
    "kernel": {"span_forward": 4, "span_backward": 4, "segment_sum": 2},
    "fused": {"fused_halo_aggregate": 2, "span_backward": 4,
              "segment_sum": 2},
    "edge": {"grouped_matmul": 4, "segment_sum": 4, "grouped_drhs": 2}}
COUNTED = ("span_forward", "span_backward", "segment_sum", "grouped_matmul",
           "grouped_drhs", "halo_exchange", "fused_halo_aggregate")


def partition_of(mode: str) -> str:
    return "edge" if mode == "edge" else "halo"


def knobs() -> Dict[str, int]:
    env = os.environ
    return {"nodes": int(env.get("MH_NODES", 2048)),
            "edges": int(env.get("MH_EDGES", 16384)),
            "rels": int(env.get("MH_RELS", 5)),
            "steps": int(env.get("MH_STEPS", 5)),
            "labelled": int(env.get("MH_LABELLED", 128)),
            "bf16": env.get("MH_BF16", "1") != "0",
            "reorder": env.get("MH_REORDER", "1") != "0"}


def make_graph(k: Dict[str, int], num_shards: int):
    """``(src, dst, typ, slots)`` as the JAX script makes them."""
    rng = np.random.default_rng(0)
    n, e, r = k["nodes"], k["edges"], k["rels"]
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)
    if k["reorder"]:
        from scaling_rgcn_training_tpu_torch.parallel.reorder import (
            locality_reorder)

        perm = locality_reorder(src, dst, n, num_shards=num_shards)
        src, dst = perm[src], perm[dst]
    return src, dst, typ, 2 * r + 1


def make_params(n_pad: int, widths, slots: int):
    """The embedding ``[n_pad, D]`` and each layer's ``(weight, root,
    bias)``, float32 numpy from seed 1: N(0, 1) rows; relation weights
    U(+-sqrt(6 / (in * out))), root U(+-sqrt(6 / (in + out))), bias 0."""
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((n_pad, widths[0])).astype(np.float32)
    layers = []
    for d_in, d_out in zip(widths[:-1], widths[1:]):
        b_w, b_r = np.sqrt(6.0 / (d_in * d_out)), np.sqrt(6.0 / (d_in + d_out))
        layers.append((
            rng.uniform(-b_w, b_w, (slots, d_in, d_out)).astype(np.float32),
            rng.uniform(-b_r, b_r, (d_in, d_out)).astype(np.float32),
            np.zeros(d_out, np.float32)))
    return emb, layers


def labels(num_nodes: int, classes: int, labelled: int):
    """``labelled`` rows spread evenly over the graph, and their one-hot
    targets (class ``i % C``)."""
    count = min(labelled, num_nodes)
    rows = (np.arange(count) * num_nodes) // count
    return rows, np.eye(classes, dtype=np.float32)[np.arange(count) % classes]


def partition(kind: str, src, dst, typ, n, slots, num_shards, cache_dir):
    """The host plan of the ``"halo"`` or ``"edge"`` partition."""
    if kind == "edge":
        from scaling_rgcn_training_tpu_torch.parallel.spmd import (
            shard_rel_edges)

        return shard_rel_edges(src, dst, typ, n, slots, num_shards,
                               cache_dir=cache_dir)
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        halo_partition_edges)

    return halo_partition_edges(src, dst, typ, n, slots, num_shards,
                                pad_to_multiple=64, halo_multiple=8,
                                cache_dir=cache_dir)


def place(kind: str, host, mesh):
    """The partition's plans of this process's shards on the mesh, and the
    rows of the embedding its loop trains (halo: ``S * n_per``, edge:
    N)."""
    if kind == "edge":
        from scaling_rgcn_training_tpu_torch.parallel.spmd import (
            device_put_sharded_edges)

        return device_put_sharded_edges(host, mesh), host.num_nodes
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        device_put_halo_edges, padded_num_nodes)

    placed = device_put_halo_edges(host, mesh)
    return placed, padded_num_nodes(placed)


def parse_mode(item: str, bf16_default: bool):
    """``'fused-bf16'`` -> ``('fused', True)``."""
    name, _, dt = item.partition("-")
    if name not in MODES or dt not in ("", "f32", "bf16"):
        raise ValueError(f"unknown mode {item!r}: library, kernel, fused or "
                         "edge, with -f32 or -bf16")
    return name, (dt == "bf16") if dt else bf16_default


def mode_tag(name: str, bf16: bool) -> str:
    return f"{name}-{'bf16' if bf16 else 'f32'}"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(mesh, edges, params, label_rows, targets, mode: str, bf16: bool,
          steps: int, save: Optional[Callable] = None) -> dict:
    """``steps`` steps of the loop on ``mesh`` (this process's shards of
    the mode's partition ``edges``): the loss series, ms/step (median
    after the first step), peak memory, the kernel launches and the
    cross-process sums' bytes of each step, and a digest of the replicated
    state after the last step; ``save(tag, arrays, sharded)`` is called
    with the state before the first step (``step0``) and after the last
    (``final``)."""
    import torch
    import torch.nn.functional as F

    from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        EXCHANGE_ENV, halo_rgcn_conv)
    from scaling_rgcn_training_tpu_torch.parallel.ipc import shared_bytes
    from scaling_rgcn_training_tpu_torch.models.heads import (
        node_rows_from_numpy)
    from scaling_rgcn_training_tpu_torch.parallel.mesh import (
        row_pick, sum_across, sum_replicated_grads)
    from scaling_rgcn_training_tpu_torch.parallel.spmd import (
        CROSS_SUM, sharded_rgcn_conv)
    from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer

    edge = partition_of(mode) == "edge"
    dev = mesh.first
    emb_host, layers_host = params
    layers = [RGCNLayer(*[torch.tensor(a, device=dev) for a in layer])
              for layer in layers_host]
    count = targets.size
    if edge:
        # replicated: every process holds every row and every label
        emb = torch.nn.Parameter(torch.tensor(emb_host, device=dev))
        rows = torch.as_tensor(label_rows, dtype=torch.int64).to(dev)
        y = torch.as_tensor(targets).to(dev)
        conv = functools.partial(sharded_rgcn_conv, backend="pallas")
        emb_leaves = [emb]
        relu = torch.relu
        take = lambda logits: logits.index_select(0, rows)
    else:
        emb = node_rows_from_numpy(emb_host, mesh)
        rows_per_proc = emb.num_rows
        lo = mesh.process_index * rows_per_proc
        mine = (label_rows >= lo) & (label_rows < lo + rows_per_proc)
        take = row_pick(label_rows[mine] - lo, emb.n_per, mesh.devices).take
        y = torch.as_tensor(targets[mine]).to(dev)
        conv = halo_rgcn_conv
        emb_leaves = list(emb.parts)
        relu = lambda z: z.map(torch.relu)
    replicated = [p for layer in layers for p in layer.parameters()]
    opt = make_optimizer([*emb_leaves, *replicated], LR, weight_decay=0.0)
    cd = torch.bfloat16 if bf16 else None

    def state(with_adam: bool):
        # each array's leaves; the embedding's shards in shard order, so
        # the file holds the node-major table (and its moments) as one
        leaves = {"emb": emb_leaves}
        for i, layer in enumerate(layers):
            for name, p in layer.named_parameters():
                leaves[f"layer{i}/{name}"] = [p]
        arrays = {n: torch.cat([p.detach() for p in ps])
                  for n, ps in leaves.items()}
        if with_adam:
            for name, ps in leaves.items():
                for moment in ("exp_avg", "exp_avg_sq"):
                    arrays[f"adam/{name}/{moment}"] = torch.cat(
                        [opt.state[p][moment] for p in ps])
        sharded = [] if edge else [n for n in arrays
                                   if n == "emb" or n.startswith("adam/emb/")]
        return arrays, sharded

    prev = os.environ.get(EXCHANGE_ENV)
    if MODES[mode] is None:
        os.environ.pop(EXCHANGE_ENV, None)
    else:
        os.environ[EXCHANGE_ENV] = MODES[mode]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, launches, sum_bytes = [], [], [], []
    try:
        if save is not None:
            save("step0", *state(False))
        for _ in range(steps):
            before = {k: LAUNCHES[k] for k in COUNTED}
            bytes0 = CROSS_SUM["bytes"]
            _sync(dev)
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            z = relu(conv(emb, edges, layers[0], mesh, compute_dtype=cd))
            logits = conv(z, edges, layers[1], mesh, compute_dtype=cd)
            part = F.binary_cross_entropy_with_logits(
                take(logits), y, reduction="sum")
            (part / count).backward()
            if not edge:
                # a halo process's layers saw its rows only; in the edge
                # partition every gradient is already whole (summing it
                # again would count root, bias and the root term P times)
                sum_replicated_grads(replicated, mesh)
            opt.step()
            losses.append((float(part.detach()) if edge else sum_across(
                float(part.detach()), mesh)) / count)
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append({k: LAUNCHES[k] - before[k] for k in COUNTED})
            sum_bytes.append(CROSS_SUM["bytes"] - bytes0)
        final, sharded = state(True)
        if save is not None:
            save("final", final, sharded)
    finally:
        if prev is None:
            os.environ.pop(EXCHANGE_ENV, None)
        else:
            os.environ[EXCHANGE_ENV] = prev
    if dev.type == "cuda":
        k = mesh.local_size
        want = {n: EXPECTED[mode].get(n, 0) * k for n in COUNTED}
        if mode == "kernel":
            want["halo_exchange"] = 4
        for i, got in enumerate(launches):
            bad = {n: (got[n], c) for n, c in want.items() if got[n] != c}
            if bad:
                raise RuntimeError(f"{mode_tag(mode, bf16)} step {i} on "
                                   f"process {mesh.process_index}: launches "
                                   f"(got, want) {bad}")
    digest = hashlib.sha256()
    for name in sorted(set(final) - set(sharded)):
        digest.update(name.encode())
        digest.update(final[name].cpu().numpy().tobytes())
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 \
        if dev.type == "cuda" else None
    return {"losses": losses, "step_ms": step_ms,
            "ms_per_step": float(np.median(step_ms[1:] or step_ms)),
            "peak_mib": peak, "shared_mib": shared_bytes(mesh) / 2**20,
            "launches": launches,
            "gathered_mb_per_step": [b / 1e6 for b in sum_bytes],
            "replicated_digest": digest.hexdigest()}


def edge_case_partition(rng, s_n: int, n_nodes: int, e: int, slots: int):
    """A host halo partition of random edges over ``s_n`` shards in which
    shard 1 (when there is one) has no halo edges and the last shard (from
    3 shards on) ships no rows; ``halo_multiple=1``."""
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        halo_partition_edges)

    n_per = -(-n_nodes // s_n)
    dst = rng.integers(0, n_nodes, e)
    src = rng.integers(0, n_nodes, e)
    owner = dst // n_per
    if s_n >= 2:
        m = owner == 1
        src[m] = np.minimum(n_per + rng.integers(0, n_per, int(m.sum())),
                            n_nodes - 1)
    if s_n >= 3:
        m = (src // n_per == s_n - 1) & (owner != s_n - 1)
        src[m] = rng.integers(0, n_per, int(m.sum()))
    typ = rng.integers(0, slots, e)
    return halo_partition_edges(src, dst, typ, n_nodes, slots, s_n,
                                pad_to_multiple=8, halo_multiple=1)


def _close(name: str, got, ref, bf16: bool) -> float:
    """f32: |got - ref| <= 1e-4 max|ref| + 1e-4 |ref|; bf16 2e-2 max|ref|."""
    import torch

    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    diff = (got - ref).abs()
    limit = 2e-2 * scale if bf16 else 1e-4 * scale + 1e-4 * ref.abs()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()) or \
            not bool((diff <= limit).all()):
        raise RuntimeError(f"{name} disagrees with its plain version")
    return float(diff.max()) if diff.numel() else 0.0


def check_across(device, per_proc=(1, 2)) -> List[dict]:
    """The library exchange, #6 and #7 across this process group at
    ``S = P * k`` for each ``k`` in ``per_proc``, against the plain
    versions over every shard in this process; raises on a mismatch."""
    import torch

    from scaling_rgcn_training_tpu_torch.parallel import fused_halo as fh
    from scaling_rgcn_training_tpu_torch.parallel import ring_halo as rh
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        device_put_halo_edges)
    from scaling_rgcn_training_tpu_torch.parallel.ipc import close_peer_sets
    from scaling_rgcn_training_tpu_torch.parallel.mesh import Mesh, make_mesh

    out = []
    for k in per_proc:
        mesh = make_mesh(devices=(device,) * k)
        s_n, first = mesh.size, mesh.first_shard
        host = edge_case_partition(np.random.default_rng(100 + s_n), s_n,
                                   301 * s_n - 3, 2500 * s_n, 7)
        whole = device_put_halo_edges(host, Mesh((device,) * s_n))
        mine = device_put_halo_edges(host, mesh)
        n_per, h = host.n_per, host.halo
        rec = {"shards": s_n, "halo": h, "fused_err": 0.0}
        for d_in, d_out in ((63, 4), (11, 63)):
            for dtype in (torch.float32, torch.bfloat16):
                rng = np.random.default_rng(s_n * 1000 + d_in)
                x = torch.as_tensor(rng.standard_normal(
                    (s_n * n_per, d_in)).astype(np.float32)).to(device)
                w = torch.as_tensor((rng.standard_normal(
                    (7, d_in, d_out)) * 0.2).astype(np.float32)).to(device)
                x, w = x.to(dtype), w.to(dtype)
                xs = list(x.split(n_per))
                sends = [xs[s].index_select(0, sh.send_idx).view(s_n, h, d_in)
                         for s, sh in enumerate(whole.shards)]
                ref = rh.halo_exchange_plain(sends)
                tag = f"S {s_n} {d_in}->{d_out} {str(dtype)[6:]}"
                for fn in (rh.halo_exchange, rh.halo_exchange_library):
                    got = fn(sends[first:first + k], mesh)
                    again = fn(sends[first:first + k], mesh)
                    _sync(device)
                    for j in range(k):
                        if not (torch.equal(got[j], ref[first + j])
                                and torch.equal(again[j], got[j])):
                            raise RuntimeError(f"{tag}: {fn.__name__} across "
                                               "processes differs")
                local = xs[first:first + k]
                aggs, bufs = fh.fused_halo_shards(local, [w] * k, mine.shards,
                                                  mesh)
                aggs2, bufs2 = fh.fused_halo_shards(local, [w] * k,
                                                    mine.shards, mesh)
                _sync(device)
                for j, sh in enumerate(mine.shards):
                    want, want_buf = fh.fused_halo_aggregate_plain(
                        xs, w, whole.shards[first + j].fused)
                    if not (torch.equal(bufs[j], want_buf)
                            and torch.equal(bufs2[j], bufs[j])
                            and torch.equal(aggs2[j], aggs[j])):
                        raise RuntimeError(f"{tag} shard {first + j}: #7 "
                                           "across processes: halo buffer "
                                           "or repeat differs")
                    rec["fused_err"] = max(rec["fused_err"], _close(
                        f"{tag} shard {first + j} #7 across processes",
                        aggs[j], want, dtype == torch.bfloat16))
        close_peer_sets(mesh)
        out.append(rec)
    return out


def check_edge_across(device, per_proc=(1, 2)) -> List[dict]:
    """One layer of the edge partition across this process group at
    ``S = P * k`` for each ``k`` in ``per_proc``: the summed output and
    the ``x`` and ``w`` cotangents against the one-process
    ``sharded_aggregate`` of every shard in this process, on a random
    graph and on 600 edges in shards of 512 rows (from 3 shards on the
    last ones hold only padding rows), float32 and bfloat16, bit for bit
    (the same per-shard tensors added in the same order). Raises on a
    mismatch."""
    import torch

    from scaling_rgcn_training_tpu_torch.parallel.mesh import Mesh, make_mesh
    from scaling_rgcn_training_tpu_torch.parallel.spmd import (
        device_put_sharded_edges, shard_rel_edges, sharded_aggregate)

    out = []
    for k in per_proc:
        mesh = make_mesh(devices=(device,) * k)
        s_n = mesh.size
        one = Mesh((device,) * s_n)
        rng = np.random.default_rng(200 + s_n)
        for n, e, pad in ((301 * s_n - 3, 2500 * s_n, 64), (300, 600, 512)):
            slots = 7
            host = shard_rel_edges(rng.integers(0, n, e), rng.integers(0, n, e),
                                   rng.integers(0, slots, e), n, slots, s_n,
                                   pad_to_multiple=pad)
            whole = device_put_sharded_edges(host, one)
            mine = device_put_sharded_edges(host, mesh)
            for d_in, d_out in ((63, 4), (11, 63)):
                for dtype in (torch.float32, torch.bfloat16):
                    rng2 = np.random.default_rng(s_n * 1000 + d_in + e)
                    t = lambda *shape: torch.as_tensor(rng2.standard_normal(
                        shape).astype(np.float32)).to(device)
                    x0, w0, g = t(n, d_in), t(slots, d_in, d_out) * 0.2, \
                        t(n, d_out)
                    res = []
                    for m, edges in ((one, whole), (mesh, mine)):
                        x = x0.to(dtype).requires_grad_()
                        w = w0.to(dtype).requires_grad_()
                        agg = sharded_aggregate(x, w, edges, m,
                                                backend="pallas")
                        res.append((agg.detach(),
                                    *torch.autograd.grad(agg, (x, w), g)))
                    _sync(device)
                    for name, got, ref in zip(("output", "dx", "dw"), *res):
                        if not (torch.equal(got, ref)
                                and bool(torch.isfinite(got).all())):
                            raise RuntimeError(
                                f"edge S {s_n} E {e} {d_in}->{d_out} "
                                f"{str(dtype)[6:]}: the {name} across "
                                "processes differs from one process's")
            out.append({"shards": s_n, "nodes": n, "edges": e,
                        "local_edges": [sh.num_edges for sh in mine.shards]})
    return out


def time_calls(mesh, hedges, d_in: int, d_out: int, reps: int = 20,
               agg_reps: int = 10) -> dict:
    """Per call at ``d_in -> d_out`` float32 over this process's shards
    (CUDA events, after one warm call): #6, the library exchange and #7
    (with its halo buffer), each beside its bound; ``halo_aggregate``'s
    forward with the library exchange and with #6, each overlapped and
    blocked (``RGCN_HALO_BLOCK_OVERLAP``); across processes also the host
    barrier alone (host clock)."""
    import torch

    from scaling_rgcn_training_tpu_torch.bwd_variants import bound
    from scaling_rgcn_training_tpu_torch.measure_overlap import (
        ARMS, EXCHANGES, env_set)
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        BLOCK_OVERLAP_ENV, EXCHANGE_ENV, halo_aggregate)
    from scaling_rgcn_training_tpu_torch.parallel import fused_halo as fh
    from scaling_rgcn_training_tpu_torch.parallel import ring_halo as rh
    from scaling_rgcn_training_tpu_torch.parallel.mesh import (
        BARRIER, NodeRows, host_barrier)

    dev, k, s_n = mesh.first, mesh.local_size, mesh.size
    n_per, h = hedges.n_per, hedges.halo
    across = mesh if mesh.multiprocess else None
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((k * n_per, d_in)).astype(
        np.float32)).to(dev)
    w = torch.as_tensor((rng.standard_normal(
        (hedges.num_slots, d_in, d_out)) * 0.2).astype(np.float32)).to(dev)
    xs = list(x.split(n_per))
    sends = [xs[j].index_select(0, sh.send_idx).view(s_n, h, d_in)
             for j, sh in enumerate(hedges.shards)]
    calls = {
        "halo_exchange": lambda: rh.halo_exchange(sends, across),
        "library_exchange": lambda: rh.halo_exchange_library(sends, across),
        "fused_halo_aggregate": lambda: fh.fused_halo_shards(
            xs, [w] * k, hedges.shards, across)}
    send_bytes = k * sends[0].numel() * sends[0].element_size()
    copy = 2 if across else 0
    costs = [fh.fused_halo_cost([xs[0]] * s_n, w, sh.fused, True,
                                copied=bool(across)) for sh in hedges.shards]
    bounds = {"halo_exchange": bound((2 + copy) * send_bytes, 0, "float32"),
              "library_exchange": bound(2 * send_bytes, 0, "float32"),
              "fused_halo_aggregate": bound(sum(c[0] for c in costs),
                                            sum(c[1] for c in costs),
                                            costs[0][2])}
    out = {"d_in": d_in, "d_out": d_out, "shards": k}

    def per_call(fn, n: int) -> float:
        fn()
        _sync(dev)
        if across:
            host_barrier(mesh)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / n

    for name, fn in calls.items():
        out[name] = {"ms": per_call(fn, reps), **bounds[name]}
    # the whole aggregation (send gathers, exchange, both segments), the
    # exchange overlapping the owner-local segment and blocked
    out["halo_aggregate"] = {}
    with torch.no_grad():
        for exchange in ("library", "kernel"):
            for arm, blocked in ARMS:
                with env_set(EXCHANGE_ENV, EXCHANGES[exchange]), \
                        env_set(BLOCK_OVERLAP_ENV, "1" if blocked else None):
                    out["halo_aggregate"][f"{exchange} {arm}"] = per_call(
                        lambda: halo_aggregate(NodeRows(tuple(xs)), w, hedges,
                                               mesh), agg_reps)
    if across:
        calls0, secs0 = BARRIER["calls"], BARRIER["seconds"]
        for _ in range(reps):
            host_barrier(mesh)
        out["barrier_ms"] = (BARRIER["seconds"] - secs0) * 1e3 / (
            BARRIER["calls"] - calls0)
    return out


def time_edge_sum(mesh, num_nodes: int, d_in: int, d_out: int,
                  slots: int, reps: int = 20) -> dict:
    """Per call (CUDA events, after one warm call): the edge partition's
    sums of a layer (``spmd.sum_shards`` over every shard of the mesh):
    forward, the shards' partials ``[N, d_out]`` float32; backward, the
    shards' ``[N, d_in]`` and ``w`` cotangents; each beside the bytes
    this process contributes to and receives from the other processes."""
    import torch

    from scaling_rgcn_training_tpu_torch.parallel.mesh import host_barrier
    from scaling_rgcn_training_tpu_torch.parallel.spmd import sum_shards

    dev, k = mesh.first, mesh.local_size
    rng = np.random.default_rng(8)
    t = lambda *shape: [torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32)).to(dev) for _ in range(k)]
    parts, gx, gw = t(num_nodes, d_out), t(num_nodes, d_in), \
        t(slots, d_in, d_out)
    calls = {"forward_sum": (lambda: sum_shards(parts, mesh), [parts]),
             "backward_sum": (lambda: (sum_shards(gx, mesh),
                                       sum_shards(gw, mesh)), [gx, gw])}
    out = {"d_in": d_in, "d_out": d_out, "shards": k}
    for name, (fn, summed) in calls.items():
        fn()
        _sync(dev)
        if mesh.multiprocess:
            host_barrier(mesh)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        sent = sum(v.numel() * v.element_size() for ts in summed for v in ts) \
            if mesh.multiprocess else 0
        out[name] = {"ms": start.elapsed_time(end) / reps,
                     "mb_out": sent / 1e6,
                     "mb_in": sent * (mesh.process_count - 1) / 1e6}
    return out


def _run_modes(args, mesh, placed, lab,
               save: Optional[Callable] = None) -> Dict[str, dict]:
    """Every mode of ``--modes`` in turn over ``placed`` (partition ->
    its plans on the mesh and the embedding's rows); ``save(mode, tag,
    arrays, sharded)`` gets each mode's state before its first step and
    after its last."""
    steps = knobs()["steps"]
    res = {}
    for name, bf16 in args.mode_list:
        tag = mode_tag(name, bf16)
        edges, rows = placed[partition_of(name)]
        params = make_params(rows, args.width_list, edges.num_slots)
        res[tag] = train(mesh, edges, params, *lab, name, bf16, steps,
                         save and functools.partial(save, tag))
    return res


def multi_ckpt(tag: str, when: str, rank: int) -> str:
    """The checkpoint a child writes for mode ``tag``: one for the process
    group in the halo partition (rank 0 writes the gathered rows), one a
    process in the edge partition (its replicated state)."""
    name = f"multi-{tag}-{when}"
    return f"{name}-rank{rank}" if tag.startswith("edge") else name


def _device(args, rank: int):
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "false")
    return torch.device("cuda", rank if args.cards > 1 else 0)


def child(args) -> None:
    """One process of the group: train every mode on its shards and print
    its record."""
    import torch.distributed as dist

    from scaling_rgcn_training_tpu_torch.parallel.ipc import close_peer_sets
    from scaling_rgcn_training_tpu_torch.parallel.mesh import (
        BARRIER, initialize_multihost, make_mesh)
    from scaling_rgcn_training_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)

    rank, work = args.child, Path(args.workdir)
    dev = _device(args, rank)
    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" and args.cards > 1 else "gloo"
    initialize_multihost(args.init_method, args.procs, rank, backend)
    mesh = make_mesh(devices=(dev,) * args.shards_per_proc)
    if not mesh.multiprocess:
        raise RuntimeError(f"process {rank}: the mesh spans one process")
    rec = {"rank": rank, "backend": backend, "device": str(dev)}
    if args.check:
        if "halo" in args.partitions:
            rec["check"] = check_across(dev)
        if "edge" in args.partitions:
            rec["edge_check"] = check_edge_across(dev)
    g = np.load(work / "graph.npz")
    placed, rec["plan_load_s"] = {}, {}
    for kind in args.partitions:
        t0 = time.perf_counter()
        host = partition(kind, g["src"], g["dst"], g["typ"], int(g["nodes"]),
                         int(g["slots"]), mesh.size, str(work / "plans"))
        rec["plan_load_s"][kind] = time.perf_counter() - t0
        placed[kind] = place(kind, host, mesh)
        del host
    lab = labels(int(g["nodes"]), args.width_list[-1], knobs()["labelled"])

    def save_for(mode, tag, arrays, sharded):
        # the edge partition's state is replicated: each process writes
        # its own file
        group = None if mode.startswith("edge") else mesh
        path = save_checkpoint(os.path.join(args.ckpt, multi_ckpt(
            mode, tag, rank)), arrays, mesh=group, node_sharded=sharded)
        back, _ = load_checkpoint(path, mesh=group, node_sharded=sharded)
        for name, v in arrays.items():
            if not np.array_equal(back[name], v.cpu().numpy()):
                raise RuntimeError(f"process {rank}: {name} of {path} read "
                                   "back differs")

    rec["modes"] = _run_modes(args, mesh, placed, lab,
                              save_for if args.ckpt else None)
    if args.time_calls:
        widths = args.width_list[0], args.width_list[1]
        if "halo" in placed:
            rec["calls"] = time_calls(mesh, placed["halo"][0], *widths)
        if "edge" in placed:
            rec["edge_calls"] = time_edge_sum(mesh, int(g["nodes"]), *widths,
                                              int(g["slots"]))
    rec["barrier"] = dict(BARRIER)
    close_peer_sets(mesh)
    print(CHILD_TAG + json.dumps(rec), flush=True)
    dist.destroy_process_group()


def _spawn(args, work: Path) -> List[dict]:
    """Run the P children to their end; raises when one fails (the others
    are killed) or the time limit passes."""
    pkg_root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    init = args.init_method
    if init is None:
        port = os.environ.get("MH_PORT")
        init = f"tcp://localhost:{port}" if port else \
            f"file://{work / f'rendezvous-{time.time_ns()}'}"
    argv = [sys.executable, "-m", __spec__.name if __spec__ else
            "scaling_rgcn_training_tpu_torch.multihost_sim",
            *args.forward, "--workdir", str(work), "--init-method", init]
    procs, logs = [], []
    try:
        for r in range(args.procs):
            out = open(work / f"child{r}.out", "w+")
            err = open(work / f"child{r}.err", "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(argv + ["--child", str(r)], env=env,
                                          stdout=out, stderr=err, text=True))
        deadline = time.monotonic() + args.timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            tails = []
            for r in failed:
                logs[r][1].seek(0)
                tails.append(f"child {r} (exit {procs[r].returncode}):\n"
                             + logs[r][1].read()[-3000:])
            raise RuntimeError("multi-process run failed\n" + "\n".join(tails))
        recs = []
        for r, (out, _) in enumerate(logs):
            out.seek(0)
            line = [ln for ln in out.read().splitlines()
                    if ln.startswith(CHILD_TAG)]
            if not line:
                raise RuntimeError(f"child {r} printed no record")
            recs.append(json.loads(line[-1][len(CHILD_TAG):]))
        return recs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


def run(argv: Optional[List[str]] = None) -> dict:
    """The parent: the oracle, then the P children; returns the record
    (raises when a child fails)."""
    import torch

    from scaling_rgcn_training_tpu_torch.parallel.mesh import Mesh
    from scaling_rgcn_training_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)

    args = parse_args(argv)
    k = knobs()
    s_n = args.procs * args.shards_per_proc
    made = args.workdir is None
    # absolute: the rendezvous file's URL and the children's --workdir
    # must not depend on the directory they are read from
    work = Path(tempfile.mkdtemp(prefix="multihost_") if made
                else args.workdir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    try:
        src, dst, typ, slots = make_graph(k, s_n)
        np.savez(work / "graph.npz", src=src, dst=dst, typ=typ,
                 nodes=k["nodes"], slots=slots)
        dev = _device(args, 0)
        mesh = Mesh((dev,) * s_n)
        rec = {"processes": args.procs, "step": "eager",
               "shards_per_process": args.shards_per_proc,
               "global_shards": s_n, "steps": k["steps"],
               "device": dev.type, "cards": args.cards,
               "kind": torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu",
               "nodes": k["nodes"], "edges": k["edges"], "slots": slots,
               "widths": args.width_list, "reorder": k["reorder"],
               "partition_build_s": {}}
        placed = {}
        for kind in args.partitions:
            t0 = time.perf_counter()
            host = partition(kind, src, dst, typ, k["nodes"], slots, s_n,
                             str(work / "plans"))
            rec["partition_build_s"][kind] = time.perf_counter() - t0
            if kind == "halo":
                rec["n_per"], rec["halo"] = host.n_per, host.halo
            else:
                rec["edge_shard_rows"] = int(host.src.shape[1])
            placed[kind] = place(kind, host, mesh)
            del host
        lab = labels(k["nodes"], args.width_list[-1], k["labelled"])
        step0 = {}

        def save_for(mode, tag, arrays, sharded):
            if tag == "step0":
                step0[mode] = {n: v.cpu().numpy().copy()
                               for n, v in arrays.items()}
            save_checkpoint(os.path.join(args.ckpt, f"single-{mode}-{tag}"),
                            arrays)

        single = _run_modes(args, mesh, placed, lab,
                            save_for if args.ckpt else None)
        widths = args.width_list[0], args.width_list[1]
        calls = time_calls(mesh, placed["halo"][0], *widths) \
            if args.time_calls and "halo" in placed else None
        edge_calls = time_edge_sum(mesh, k["nodes"], *widths, slots) \
            if args.time_calls and "edge" in placed else None
        del placed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        children = _spawn(args, work)
        rec["backend"] = children[0]["backend"]
        rec["modes"] = {}
        for tag, s in single.items():
            runs = [c["modes"][tag] for c in children]
            multi = runs[0]["losses"]
            rtol, atol = (5e-3, 5e-3 * abs(s["losses"][0])) \
                if tag.endswith("bf16") else (1e-5, 1e-6)
            m = rec["modes"][tag] = {
                "single_process_losses": s["losses"],
                "multi_process_losses": multi,
                "loss_parity": bool(np.allclose(s["losses"], multi,
                                                rtol=rtol, atol=atol)),
                "rtol": rtol, "atol": atol,
                # every process ended with the same loss series and the
                # same bits of every replicated tensor and Adam moment
                "replicated_bits_equal": all(
                    r["losses"] == multi and r["replicated_digest"]
                    == runs[0]["replicated_digest"] for r in runs),
                "single_ms_per_step": s["ms_per_step"],
                "single_peak_mib": s["peak_mib"],
                "ms_per_step": [r["ms_per_step"] for r in runs],
                "peak_mib": [r["peak_mib"] for r in runs],
                "shared_mib": [r["shared_mib"] for r in runs],
                "launches": [r["launches"] for r in runs],
                "gathered_mb_per_step": [max(r["gathered_mb_per_step"])
                                         for r in runs]}
            if tag.startswith("edge"):
                # the forward adds the same partials in the same order (and
                # the backward the same cotangents)
                m["first_loss_same_bits"] = multi[0] == s["losses"][0]
                m["loss_series_same_bits"] = multi == s["losses"]
                m["loss_parity"] = m["loss_parity"] and \
                    m["first_loss_same_bits"]
        first = next(iter(rec["modes"].values()))
        rec["single_process_losses"] = first["single_process_losses"]
        rec["multi_process_losses"] = first["multi_process_losses"]
        rec["loss_parity"] = all(m["loss_parity"]
                                 for m in rec["modes"].values())
        rec["replicated_bits_equal"] = all(
            m["replicated_bits_equal"] for m in rec["modes"].values())
        rec["plan_load_s"] = [c["plan_load_s"] for c in children]
        rec["barrier"] = [c["barrier"] for c in children]
        if args.check:
            for key in ("check", "edge_check"):
                if key in children[0]:
                    rec[key] = [c[key] for c in children]
        if calls is not None:
            rec["calls"] = {"single": calls,
                            "multi": [c["calls"] for c in children]}
        if edge_calls is not None:
            rec["edge_calls"] = {"single": edge_calls,
                                 "multi": [c["edge_calls"] for c in children]}
        if args.ckpt:
            same = []
            for mode, state in step0.items():
                arrays, _ = load_checkpoint(os.path.join(
                    args.ckpt, multi_ckpt(mode, "step0", 0)))
                same.append(sorted(arrays) == sorted(state) and all(
                    np.array_equal(arrays[n], v) for n, v in state.items()))
            rec["ckpt_step0_bits_equal"] = all(same)
        return rec
    finally:
        if made:
            shutil.rmtree(work, ignore_errors=True)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--shards-per-proc", type=int, default=4)
    ap.add_argument("--cards", type=int, default=None,
                    help="1: the processes share cuda:0 (gloo); P: a card "
                         "each (NCCL); default P when the machine has P")
    ap.add_argument("--modes", default=None)
    ap.add_argument("--widths", default="16,8,4")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time-calls", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--child", type=int, default=None)
    args = ap.parse_args(argv)
    if args.cards is None:
        import torch

        have = torch.cuda.device_count() if args.device == "cuda" and \
            torch.cuda.is_available() else 0
        args.cards = args.procs if have >= args.procs else 1
    if args.cards not in (1, args.procs):
        raise SystemExit(f"--cards is 1 or --procs ({args.procs})")
    args.width_list = [int(v) for v in args.widths.split(",")]
    if len(args.width_list) != 3:
        raise SystemExit("--widths D,HL,C")
    if args.modes is None:
        from scaling_rgcn_training_tpu_torch.parallel.halo import exchange_mode

        args.modes = {None: "library", "kernel": "kernel",
                      "fused": "fused"}[exchange_mode()]
    bf16 = knobs()["bf16"]
    args.mode_list = [parse_mode(m, bf16) for m in args.modes.split(",")]
    args.partitions = list(dict.fromkeys(
        partition_of(name) for name, _ in args.mode_list))
    # what a child is given again: every option but the parent's own
    args.forward = ["--device", args.device, "--procs", str(args.procs),
                    "--shards-per-proc", str(args.shards_per_proc),
                    "--cards", str(args.cards), "--modes", args.modes,
                    "--widths", args.widths,
                    *(["--check"] if args.check else []),
                    *(["--time-calls"] if args.time_calls else []),
                    *(["--ckpt", args.ckpt] if args.ckpt else [])]
    return args


def main() -> None:
    args = parse_args()
    if args.child is not None:
        child(args)
        return
    rec = run(sys.argv[1:])
    print(json.dumps(rec), flush=True)
    if not (rec["loss_parity"] and rec["replicated_bits_equal"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
