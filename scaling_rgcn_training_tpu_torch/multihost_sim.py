"""Halo training across processes: P processes x k shards against the
single-process run of the same S = P * k shards.

Counterpart of the JAX package's ``scripts/multihost_sim.py``:

    python -m scaling_rgcn_training_tpu_torch.multihost_sim \\
        [--device cpu|cuda] [--procs P] [--shards-per-proc k] [--cards C] \\
        [--modes library,kernel,fused-bf16,...] [--widths D,HL,C] \\
        [--check] [--time-calls] [--ckpt DIR] [--workdir DIR]

The parent makes the graph from numpy seed 0 as the JAX script does
(``src``, ``dst`` uniform over N, the relation over 2R; locality reorder
with ``MH_REORDER``), builds the halo partition of S shards once into a
plan cache in its work directory, runs the single-process S-shard run of
each mode (the oracle), then spawns P children (``--child r``). Each joins
the process group (``parallel/mesh.py`` ``initialize_multihost``: gloo on
the CPU and when the processes share a card, NCCL with a card each; the
rendezvous is ``tcp://localhost:MH_PORT`` with ``MH_PORT`` set, else a
file in the work directory), loads the partition from the plan cache and
runs the same loop with its k shards, the exchange crossing the
processes. The parent prints one JSON line: per mode both loss series and
``loss_parity`` (float32 ``np.allclose(rtol=1e-5, atol=1e-6)``, the JAX
script's; bfloat16 streams ``rtol=5e-3`` with ``atol`` 5e-3 of the first
loss: as the loop learns the labels the loss falls ~1000x, and a bf16
rounding that the float32 sums' other order flips moves a loss of 0.002
by a few percent while the difference stays ~1e-4 of the first loss),
ms/step, peak memory and each process's kernel launches a step, and
exits 1 unless every mode matches.
A child that fails makes the run raise; the others are killed.

The loop: embedding ``[S * n_per, D]`` -> halo conv -> ReLU -> halo conv
-> BCE over the labelled rows -> Adam 0.05 (no L2), the parameters drawn
with ``np.random.default_rng`` (seed 1; the layers as ``init_rgcn_layer``
draws them). A process's loss is the sum over its labelled rows, summed
over the processes in rank order and divided by the global count; the
layers' gradients are summed across processes
(``mesh.sum_replicated_grads``). The labelled rows (``MH_LABELLED``,
128 as in the JAX script) are spread evenly over the graph (the JAX
script takes the first 128, which all lie on process 0).

``--modes``: ``library``, ``kernel`` (#6) or ``fused`` (#7), each with
``-f32`` or ``-bf16`` for its edge streams (default ``MH_BF16``); by
default the one mode ``RGCN_HALO_PALLAS_A2A`` picks, as in the JAX
package. On the card every child must launch each of its mode's kernels
the expected number of times on every step (#1 and #2, #3 for the send
transposes, #6 or #7), or it fails.

``--check``: each child holds the library exchange, #6 and #7 across
processes against the single-process plain versions on the whole data
(the exchanges and the halo buffers bit for bit, #7's sums within f32
1e-4 / bf16 2e-2 of max|ref|; two runs the same bits) at S = P and 2P
over graphs where a shard has no halo edges and (from 3 shards) a peer
ships no rows, float32 and bfloat16. ``--time-calls`` (card): each
exchange and #7 per call at layer 1's width across processes, and by the
parent in one process, beside their bounds (``fused_halo_cost`` with the
``x_own`` copy), and the host barrier alone. ``--ckpt DIR``: each mode's
state before its first step and after its last written through
``utils/checkpoint.py`` by both layouts (``{single,multi}-{mode}-{step0,
final}.npz``); every child reads the multi files back and checks its
rows, and the parent reads the multi step-0 files into one process and
checks their bits against its own.

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
MODES = {"library": None, "kernel": "1", "fused": "fused"}
# per step and shard of a process: (forward) the local and halo span
# forwards of both layers, (backward) their span backwards and the send
# gathers' transposes (#3); #6 per exchange call, #7 per shard and layer
EXPECTED = {
    "library": {"span_forward": 4, "span_backward": 4, "segment_sum": 2},
    "kernel": {"span_forward": 4, "span_backward": 4, "segment_sum": 2},
    "fused": {"fused_halo_aggregate": 2, "span_backward": 4,
              "segment_sum": 2}}
COUNTED = ("span_forward", "span_backward", "segment_sum", "halo_exchange",
           "fused_halo_aggregate")


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


def partition(src, dst, typ, n, slots, num_shards, cache_dir):
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        halo_partition_edges)

    return halo_partition_edges(src, dst, typ, n, slots, num_shards,
                                pad_to_multiple=64, halo_multiple=8,
                                cache_dir=cache_dir)


def parse_mode(item: str, bf16_default: bool):
    """``'fused-bf16'`` -> ``('fused', True)``."""
    name, _, dt = item.partition("-")
    if name not in MODES or dt not in ("", "f32", "bf16"):
        raise ValueError(f"unknown mode {item!r}: library, kernel or fused, "
                         "with -f32 or -bf16")
    return name, (dt == "bf16") if dt else bf16_default


def mode_tag(name: str, bf16: bool) -> str:
    return f"{name}-{'bf16' if bf16 else 'f32'}"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(mesh, hedges, params, label_rows, targets, mode: str, bf16: bool,
          steps: int, save: Optional[Callable] = None) -> dict:
    """``steps`` steps of the loop on ``mesh`` (this process's shards):
    the loss series, ms/step (median after the first step), peak memory
    and the kernel launches of each step; ``save(tag, arrays, sharded)``
    is called with the state before the first step (``step0``) and after
    the last (``final``)."""
    import torch
    import torch.nn.functional as F

    from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        EXCHANGE_ENV, halo_rgcn_conv)
    from scaling_rgcn_training_tpu_torch.parallel.ipc import shared_bytes
    from scaling_rgcn_training_tpu_torch.parallel.mesh import (
        put_global, sum_across, sum_replicated_grads)
    from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer

    dev = mesh.first
    emb_host, layers_host = params
    emb = torch.nn.Parameter(put_global(emb_host, mesh))
    layers = [RGCNLayer(*[torch.tensor(a, device=dev) for a in layer])
              for layer in layers_host]
    rows_per_proc = emb.shape[0]
    lo = mesh.process_index * rows_per_proc
    mine = (label_rows >= lo) & (label_rows < lo + rows_per_proc)
    rows = torch.as_tensor(label_rows[mine] - lo, dtype=torch.int64).to(dev)
    y = torch.as_tensor(targets[mine]).to(dev)
    count = targets.size
    replicated = [p for layer in layers for p in layer.parameters()]
    opt = make_optimizer([emb, *replicated], LR, weight_decay=0.0)
    cd = torch.bfloat16 if bf16 else None

    def state(with_adam: bool):
        arrays = {"emb": emb}
        for i, layer in enumerate(layers):
            for name, p in layer.named_parameters():
                arrays[f"layer{i}/{name}"] = p
        if with_adam:
            for name, p in list(arrays.items()):
                for moment in ("exp_avg", "exp_avg_sq"):
                    arrays[f"adam/{name}/{moment}"] = opt.state[p][moment]
        sharded = [n for n in arrays
                   if n == "emb" or n.startswith("adam/emb/")]
        return {n: v.detach() for n, v in arrays.items()}, sharded

    prev = os.environ.get(EXCHANGE_ENV)
    if MODES[mode] is None:
        os.environ.pop(EXCHANGE_ENV, None)
    else:
        os.environ[EXCHANGE_ENV] = MODES[mode]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, launches = [], [], []
    try:
        if save is not None:
            save("step0", *state(False))
        for _ in range(steps):
            before = {k: LAUNCHES[k] for k in COUNTED}
            _sync(dev)
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            z = torch.relu(halo_rgcn_conv(emb, hedges, layers[0], mesh,
                                          compute_dtype=cd))
            logits = halo_rgcn_conv(z, hedges, layers[1], mesh,
                                    compute_dtype=cd)
            part = F.binary_cross_entropy_with_logits(
                logits.index_select(0, rows), y, reduction="sum")
            (part / count).backward()
            sum_replicated_grads(replicated, mesh)
            opt.step()
            losses.append(sum_across(float(part.detach()), mesh) / count)
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append({k: LAUNCHES[k] - before[k] for k in COUNTED})
        if save is not None:
            save("final", *state(True))
    finally:
        if prev is None:
            os.environ.pop(EXCHANGE_ENV, None)
        else:
            os.environ[EXCHANGE_ENV] = prev
    if dev.type == "cuda":
        k = mesh.local_size
        want = {n: c * k for n, c in EXPECTED[mode].items()}
        if mode == "kernel":
            want["halo_exchange"] = 4
        for i, got in enumerate(launches):
            bad = {n: (got[n], c) for n, c in want.items() if got[n] != c}
            if bad:
                raise RuntimeError(f"{mode_tag(mode, bf16)} step {i} on "
                                   f"process {mesh.process_index}: launches "
                                   f"(got, want) {bad}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 \
        if dev.type == "cuda" else None
    return {"losses": losses, "step_ms": step_ms,
            "ms_per_step": float(np.median(step_ms[1:] or step_ms)),
            "peak_mib": peak, "shared_mib": shared_bytes(mesh) / 2**20,
            "launches": launches}


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


def time_calls(mesh, hedges, d_in: int, d_out: int, reps: int = 20) -> dict:
    """Per call at ``d_in -> d_out`` float32 over this process's shards
    (CUDA events, after one warm call): #6, the library exchange and #7
    (with its halo buffer), each beside its bound; across processes also
    the host barrier alone (host clock)."""
    import torch

    from scaling_rgcn_training_tpu_torch.bwd_variants import bound
    from scaling_rgcn_training_tpu_torch.parallel import fused_halo as fh
    from scaling_rgcn_training_tpu_torch.parallel import ring_halo as rh
    from scaling_rgcn_training_tpu_torch.parallel.mesh import (
        BARRIER, host_barrier)

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
    for name, fn in calls.items():
        fn()
        _sync(dev)
        if across:
            host_barrier(mesh)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        out[name] = {"ms": start.elapsed_time(end) / reps, **bounds[name]}
    if across:
        calls0, secs0 = BARRIER["calls"], BARRIER["seconds"]
        for _ in range(reps):
            host_barrier(mesh)
        out["barrier_ms"] = (BARRIER["seconds"] - secs0) * 1e3 / (
            BARRIER["calls"] - calls0)
    return out


def _run_modes(args, mesh, hedges, params, lab,
               save: Optional[Callable] = None) -> Dict[str, dict]:
    """Every mode of ``--modes`` in turn; ``save(mode, tag, arrays,
    sharded)`` gets each mode's state before its first step and after its
    last."""
    steps = knobs()["steps"]
    res = {}
    for name, bf16 in args.mode_list:
        tag = mode_tag(name, bf16)
        res[tag] = train(mesh, hedges, params, *lab, name, bf16, steps,
                         save and functools.partial(save, tag))
    return res


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

    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        device_put_halo_edges, padded_num_nodes)
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
    rec = {"rank": rank, "backend": backend, "device": str(dev)}
    if args.check:
        rec["check"] = check_across(dev)
    g = np.load(work / "graph.npz")
    t0 = time.perf_counter()
    host = partition(g["src"], g["dst"], g["typ"], int(g["nodes"]),
                     int(g["slots"]), mesh.size, str(work / "plans"))
    rec["plan_load_s"] = time.perf_counter() - t0
    hedges = device_put_halo_edges(host, mesh)
    del host
    params = make_params(padded_num_nodes(hedges), args.width_list,
                         int(g["slots"]))
    lab = labels(int(g["nodes"]), args.width_list[-1], knobs()["labelled"])

    def save_for(mode, tag, arrays, sharded):
        path = save_checkpoint(
            os.path.join(args.ckpt, f"multi-{mode}-{tag}"), arrays,
            mesh=mesh, node_sharded=sharded)
        back, _ = load_checkpoint(path, mesh=mesh, node_sharded=sharded)
        for name, v in arrays.items():
            if not np.array_equal(back[name], v.cpu().numpy()):
                raise RuntimeError(f"process {rank}: {name} of {path} read "
                                   "back differs")

    rec["modes"] = _run_modes(args, mesh, hedges, params, lab,
                              save_for if args.ckpt else None)
    if args.time_calls:
        rec["calls"] = time_calls(mesh, hedges, args.width_list[0],
                                  args.width_list[1])
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

    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        device_put_halo_edges, padded_num_nodes)
    from scaling_rgcn_training_tpu_torch.parallel.mesh import Mesh
    from scaling_rgcn_training_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)

    args = parse_args(argv)
    k = knobs()
    s_n = args.procs * args.shards_per_proc
    made = args.workdir is None
    work = Path(tempfile.mkdtemp(prefix="multihost_") if made
                else args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    try:
        src, dst, typ, slots = make_graph(k, s_n)
        np.savez(work / "graph.npz", src=src, dst=dst, typ=typ,
                 nodes=k["nodes"], slots=slots)
        t0 = time.perf_counter()
        host = partition(src, dst, typ, k["nodes"], slots, s_n,
                         str(work / "plans"))
        build_s = time.perf_counter() - t0
        dev = _device(args, 0)
        mesh = Mesh((dev,) * s_n)
        hedges = device_put_halo_edges(host, mesh)
        params = make_params(padded_num_nodes(hedges), args.width_list, slots)
        lab = labels(k["nodes"], args.width_list[-1], k["labelled"])
        step0 = {}

        def save_for(mode, tag, arrays, sharded):
            if tag == "step0":
                step0[mode] = {n: v.cpu().numpy().copy()
                               for n, v in arrays.items()}
            save_checkpoint(os.path.join(args.ckpt, f"single-{mode}-{tag}"),
                            arrays)

        single = _run_modes(args, mesh, hedges, params, lab,
                            save_for if args.ckpt else None)
        calls = time_calls(mesh, hedges, args.width_list[0],
                           args.width_list[1]) if args.time_calls else None
        rec = {"processes": args.procs,
               "shards_per_process": args.shards_per_proc,
               "global_shards": s_n, "steps": k["steps"],
               "device": dev.type, "cards": args.cards,
               "kind": torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu",
               "nodes": k["nodes"], "edges": k["edges"], "slots": slots,
               "widths": args.width_list, "n_per": host.n_per,
               "halo": host.halo, "partition_build_s": build_s,
               "reorder": k["reorder"]}
        del hedges, host
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        children = _spawn(args, work)
        rec["backend"] = children[0]["backend"]
        rec["modes"] = {}
        for tag, s in single.items():
            multi = children[0]["modes"][tag]["losses"]
            rtol, atol = (5e-3, 5e-3 * abs(s["losses"][0])) \
                if tag.endswith("bf16") else (1e-5, 1e-6)
            rec["modes"][tag] = {
                "single_process_losses": s["losses"],
                "multi_process_losses": multi,
                "loss_parity": bool(np.allclose(s["losses"], multi,
                                                rtol=rtol, atol=atol)),
                "rtol": rtol, "atol": atol,
                "single_ms_per_step": s["ms_per_step"],
                "single_peak_mib": s["peak_mib"],
                "ms_per_step": [c["modes"][tag]["ms_per_step"]
                                for c in children],
                "peak_mib": [c["modes"][tag]["peak_mib"] for c in children],
                "shared_mib": [c["modes"][tag]["shared_mib"]
                               for c in children],
                "launches": [c["modes"][tag]["launches"] for c in children]}
        first = next(iter(rec["modes"].values()))
        rec["single_process_losses"] = first["single_process_losses"]
        rec["multi_process_losses"] = first["multi_process_losses"]
        rec["loss_parity"] = all(m["loss_parity"]
                                 for m in rec["modes"].values())
        rec["plan_load_s"] = [c["plan_load_s"] for c in children]
        rec["barrier"] = [c["barrier"] for c in children]
        if args.check:
            rec["check"] = [c["check"] for c in children]
        if calls is not None:
            rec["calls"] = {"single": calls,
                            "multi": [c["calls"] for c in children]}
        if args.ckpt:
            same = []
            for mode, state in step0.items():
                arrays, _ = load_checkpoint(os.path.join(
                    args.ckpt, f"multi-{mode}-step0"))
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
    if not rec["loss_parity"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
