"""Scaling-efficiency benchmark: edges/s against shard count over the halo
partition.

Counterpart of the JAX package's ``scripts/bench_scaling.py``:

    python -m scaling_rgcn_training_tpu_torch.bench_scaling \\
        [--max-shards K] [--trace DIR] [--virtual]

The north star (BASELINE.md) asks that the per-card edge throughput of the
forward and backward train step keep >= 80% efficiency as cards are added.
For each shard count k of ``(1, 2, 4, 8, 16, 32)`` up to ``--max-shards``
(default: the card count; 1 on the CPU, where it plays the part of the JAX
run's forced host device count) it prints one JSON line with the JAX
script's keys, ``devices``, ``ms_per_step``, ``edges_per_s``,
``efficiency`` (T_1 / (k T_k)), ``throughput_retention`` (T_1 / T_k),
``hardware`` (``cuda`` or ``cpu``), ``halo_rows_per_shard`` (H (k - 1),
the padded rows a shard receives a layer) and ``measures_hardware_scaling``,
and the port's: ``exchange`` (``library``, ``#6`` or ``#7``, from
``RGCN_HALO_PALLAS_A2A`` as the halo conv reads it), ``compute_dtype``,
``device`` (``nvidia-smi``'s name and power limit), ``cards`` (the
distinct devices the shards lie on), ``host_ms_per_step`` (the host's
time to issue a timed step, before the final synchronisation: near
``ms_per_step``, the host bounds the step), ``peak_mib`` (the largest
card's, all that the process holds there), ``peak_mib_per_card`` (each
card's peak above what it held before the count began: this count's
rows, moments, plans and step, by card index),
``cross_card_mb_per_step`` (MB copied between two cards a timed step,
from the port's own counter, ``parallel/mesh.py`` ``CROSS_CARD``: the
halo exchange, the replicated parameters out and their cotangents back,
the labelled rows' logits and their cotangents; on one card 0),
``launches_per_step`` (each kernel wrapper's launches over the
timed steps, per step), ``device_busy_ms_per_step`` (with ``--trace``:
each card's kernel and copy ms a step over ``BENCH_INNER`` traced steps
after the timed ones, by card index; else null),
``peer_copy_mb_per_step`` (with ``--trace``: the profiler's card-to-card
copies in those steps, MB a step, ``tracing.peer_copy_bytes``: the
library exchange's check of ``cross_card_mb_per_step``; else null),
``step`` (the route of
the step, ``train/step_graph.py``: ``"graph"`` where every shard lies on
one card, the step captured once as a CUDA graph and replayed, as the
JAX script runs its steps in one jitted ``lax.scan``; ``"eager"`` over
several cards, whose capture would need a graph per card, on the CPU, or
with ``RGCN_EAGER_STEP`` set) and ``losses`` (every step's, warm-up calls
included).

k up to the card count puts the shards on k cards (``parallel/mesh.py``
``make_mesh(k)``); beyond it, with ``--virtual`` and on the CPU, the k
shards are virtual shards of one device. ``measures_hardware_scaling``
is true only when the k shards lie on k distinct cards: virtual shards
share one card's silicon, so their ``efficiency`` is no scaling figure
(the JAX rule, ``hardware != "cpu"``, would call them hardware scaling);
``throughput_retention`` is then the partitioning and exchange overhead.

The graph is the script's, from one ``np.random.default_rng(0)``:
``BENCH_GRAPH=sbm`` (default; :func:`sbm_edges`: ``BENCH_COMMUNITIES``
communities, a share ``BENCH_P_IN`` of the edges inside one) or
``random``, then the relation of every edge in ``[0, 2R)``. For k > 1 and
``BENCH_REORDER`` not 0, ``parallel/reorder.py`` ``locality_reorder``
renumbers the nodes first. Each count then runs ``halo_partition_edges``
(``pad_to_multiple=512``) and ``device_put_halo_edges`` onto its mesh, and
a step of the script's: an embedding of ``padded_num_nodes`` rows
node-sharded as the script places it (``node_sharding``: one Parameter a
shard on its shard's device, so Adam's moments lie with the rows), two
``halo_rgcn_conv`` layers (d -> hidden -> 8) with a ReLU between, BCE on
1,024 labelled rows with one-hot labels ``i % 8`` (each shard picks the
labelled rows it owns, ``mesh.RowPick``; BCE on the mesh's first device),
Adam 0.01 without L2.
Unlike the script, which draws a fresh embedding over each count's
padded rows and labels the first 1,024 rows of the new numbering, every
count trains one model: the embedding ``[N, d]`` N(0, 1) from
``torch.Generator`` seed 0, each node's row moved to its new id (padding
rows zero), the layers from seeds 1 and 2, and the labelled rows nodes
``0 .. 1023`` wherever the reorder puts them; so each count's losses
equal one card's up to the order of the sums. Timing as the script's: a
warm-up call, a chained warm-up call, then ``BENCH_CALLS`` x
``BENCH_INNER`` chained steps with one synchronisation of every card at
their end.

Env knobs (the script's, with its defaults): ``BENCH_NODES`` (100,000),
``BENCH_EDGES`` (2,000,000), ``BENCH_RELS`` (20), ``BENCH_DIM`` (64),
``BENCH_HIDDEN`` (16), ``BENCH_INNER`` (5), ``BENCH_CALLS`` (3),
``BENCH_GRAPH``, ``BENCH_COMMUNITIES`` (64), ``BENCH_P_IN`` (0.9),
``BENCH_REORDER`` (1), ``BENCH_COMPUTE_DTYPE`` (``bf16``/``bfloat16``:
bfloat16 streams; float32 otherwise); and ``BENCH_DEVICE`` (``cuda``:
raises without a card; ``cpu``: virtual CPU shards and the kernels' plain
versions, for tests).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch import rehearse_am as ra
from scaling_rgcn_training_tpu_torch.bench import resolve_device
from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
from scaling_rgcn_training_tpu_torch.parallel.halo import (
    device_put_halo_edges, exchange_name, halo_partition_edges,
    halo_rgcn_conv, padded_num_nodes)
from scaling_rgcn_training_tpu_torch.parallel.mesh import (
    CROSS_CARD, make_mesh, node_sharding, norm_device, row_pick)
from scaling_rgcn_training_tpu_torch.parallel.reorder import locality_reorder
from scaling_rgcn_training_tpu_torch.train.step_graph import (
    EAGER_ENV, CudaStepGraph, StepGraph, step_route)
from scaling_rgcn_training_tpu_torch.utils import tracing

COUNTS = (1, 2, 4, 8, 16, 32)
CLASSES = 8
LABELLED = 1024
NUM_LAYERS = 2
LR = 0.01


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def knobs() -> Dict[str, object]:
    env = os.environ
    bf16 = env.get("BENCH_COMPUTE_DTYPE", "").lower() in ("bf16", "bfloat16")
    return {"nodes": int(env.get("BENCH_NODES", 100_000)),
            "edges": int(env.get("BENCH_EDGES", 2_000_000)),
            "rels": int(env.get("BENCH_RELS", 20)),
            "dim": int(env.get("BENCH_DIM", 64)),
            "hidden": int(env.get("BENCH_HIDDEN", 16)),
            "inner": int(env.get("BENCH_INNER", 5)),
            "calls": int(env.get("BENCH_CALLS", 3)),
            "graph": env.get("BENCH_GRAPH", "sbm"),
            "communities": int(env.get("BENCH_COMMUNITIES", 64)),
            "p_in": float(env.get("BENCH_P_IN", 0.9)),
            "reorder": env.get("BENCH_REORDER", "1") != "0",
            "compute_dtype": torch.bfloat16 if bf16 else None,
            "device": env.get("BENCH_DEVICE", "cuda")}


def sbm_edges(rng, n: int, e: int, n_comm: int, p_in: float):
    """``(src, dst)`` int32 of a stochastic block model, drawn from ``rng``
    as the script draws them: each node's community, then for a share
    ``p_in`` of the edges both ends in one community picked uniformly,
    and uniform ends for the rest."""
    comm = rng.integers(0, n_comm, n)
    order_c = np.argsort(comm, kind="stable")
    csize = np.bincount(comm, minlength=n_comm)
    coff = np.concatenate([[0], np.cumsum(csize)])
    intra = rng.random(e) < p_in
    ei = int(intra.sum())
    ci_ = rng.integers(0, n_comm, ei)
    pick = lambda: order_c[coff[ci_]
                           + (rng.random(ei) * csize[ci_]).astype(np.int64)]
    src = np.empty(e, np.int64)
    dst = np.empty(e, np.int64)
    src[intra], dst[intra] = pick(), pick()
    m = e - ei
    src[~intra] = rng.integers(0, n, m)
    dst[~intra] = rng.integers(0, n, m)
    return src.astype(np.int32), dst.astype(np.int32)


def graph(k: Dict[str, object]):
    """``(src, dst, typ, slots)``: the script's draws from
    ``default_rng(0)``."""
    n, e = k["nodes"], k["edges"]
    rng = np.random.default_rng(0)
    if k["graph"] == "sbm":
        src, dst = sbm_edges(rng, n, e, k["communities"], k["p_in"])
    else:
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
    typ = rng.integers(0, 2 * k["rels"], e).astype(np.int32)
    return src, dst, typ, 2 * k["rels"] + 1


def partition(src, dst, typ, n: int, slots: int, shards: int,
              reorder: bool):
    """``(perm, halo partition on the CPU)``: ``perm[old] = new`` from
    ``locality_reorder`` (for ``shards > 1`` and ``reorder``; else the
    identity), then ``halo_partition_edges`` of the renumbered edges."""
    perm = np.arange(n, dtype=np.int32)
    if reorder and shards > 1:
        perm = locality_reorder(src, dst, n, num_shards=shards)
    return perm, halo_partition_edges(perm[src], perm[dst], typ, n, slots,
                                      shards, pad_to_multiple=512)


def shard_devices(shards: int, device: torch.device,
                  virtual: bool = False) -> tuple:
    """k cards when the machine has them (and not ``virtual``), else k
    virtual shards of ``device``."""
    if device.type == "cuda" and not virtual and \
            shards <= torch.cuda.device_count():
        return tuple(torch.device("cuda", i) for i in range(shards))
    return (norm_device(device),) * shards


def make_params(k: Dict[str, object], perm: np.ndarray, n_pad: int,
                slots: int, mesh):
    """``(embedding, [layer 1, layer 2])``: the embedding ``[n_pad, d]``
    node-sharded over ``mesh`` (``NodeRows`` of one Parameter a shard, on
    its shard's device), node ``i``'s row at ``perm[i]``, padding rows
    zero (see the module's docstring); the layers on ``mesh.first``."""
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import init_rgcn_layer

    gen = lambda seed: torch.Generator().manual_seed(seed)
    emb = torch.zeros(n_pad, k["dim"])
    emb[torch.as_tensor(perm, dtype=torch.int64)] = torch.randn(
        (k["nodes"], k["dim"]), generator=gen(0))
    layers = [init_rgcn_layer(gen(1), slots, k["dim"], k["hidden"]),
              init_rgcn_layer(gen(2), slots, k["hidden"], CLASSES)]
    return (node_sharding(emb, mesh).as_parameters(),
            [layer.to(mesh.first) for layer in layers])


def sync(devices: Sequence[torch.device]) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def device_busy_ms(prof, steps: int) -> Dict[str, float]:
    """Each card's kernel and copy time a step in a profile (the sum of
    its device events; the annotated ranges left out), keyed by the
    card's index."""
    busy: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            key = str(e.device_index)
            busy[key] = busy.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return {key: ms / steps for key, ms in sorted(busy.items())}


def measure(k: Dict[str, object], shards: int, perm: np.ndarray, host_edges,
            slots: int, device: torch.device,
            trace_dir: Optional[str] = None, virtual: bool = False) -> dict:
    """One count's record (without the ratios to the first count): the
    partition placed on its mesh, the warm-up calls and the timed steps;
    with ``trace_dir``, ``BENCH_INNER`` more steps under
    ``utils/tracing.py`` ``trace`` (a Chrome trace in
    ``trace_dir/k<count>``, the steps annotated ``bench_scaling_step``)
    and each card's busy ms a step in them."""
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss
    from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer

    devices = shard_devices(shards, device, virtual)
    cards = sorted({d for d in devices if d.type == "cuda"}, key=str)
    # an earlier count's optimizer can sit in a reference cycle (frames
    # of torch.optim's own) until the cycle collector runs: collect it,
    # then take what each card holds before this count as its base
    gc.collect()
    base = {d: torch.cuda.memory_allocated(d) for d in cards}
    for dev in cards:
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh(devices=devices)
    hedges = device_put_halo_edges(host_edges, mesh)
    emb, layers = make_params(k, perm, padded_num_nodes(hedges), slots, mesh)
    count = min(LABELLED, k["nodes"])
    pick = row_pick(perm[:count], hedges.n_per, mesh.devices)
    y = torch.eye(CLASSES)[torch.arange(count) % CLASSES].to(mesh.first)
    params = [*emb.parts, *(p for l in layers for p in l.parameters())]
    opt = make_optimizer(params, LR)
    cd = k["compute_dtype"]

    def conv(x, layer):
        return halo_rgcn_conv(x, hedges, layer, mesh, compute_dtype=cd)

    def step():
        opt.zero_grad(set_to_none=True)
        z = conv(emb, layers[0]).map(torch.relu)
        loss = bce_loss(pick.take(conv(z, layers[1])), y)
        loss.backward()
        opt.step()
        return (loss,)

    inner, timed = k["inner"], k["calls"] * k["inner"]
    route = step_route(devices)
    total = 2 * inner + timed + (inner if trace_dir is not None else 0)
    with StepGraph(step, total, 1, mesh.first,
                   CudaStepGraph(mesh.first) if route == "graph" else None,
                   params=params) as loop:

        def steps(n: int) -> None:
            for _ in range(n):
                loop.run()

        steps(inner)                      # warm-up: the kernels' first use
        steps(inner)                      # chained warm-up
        sync(devices)
        before, crossed = dict(LAUNCHES), CROSS_CARD["bytes"]
        t0 = time.perf_counter()
        steps(timed)
        host = (time.perf_counter() - t0) / timed
        sync(devices)
        dt = (time.perf_counter() - t0) / timed
        launches = {n: (v - before[n]) / timed for n, v in LAUNCHES.items()}
        crossed = (CROSS_CARD["bytes"] - crossed) / timed
        losses = [row[0] for row in loop.rows(0, loop.done)]
        busy = traced = None
        if trace_dir is not None:
            with tracing.trace(os.path.join(trace_dir, f"k{shards}")) as prof:
                with tracing.annotate("bench_scaling_step"):
                    steps(inner)
                sync(devices)
            busy = device_busy_ms(prof, inner)
            if prof.trace_path is not None:
                traced = tracing.peer_copy_bytes(
                    tracing.gpu_events(prof.trace_path)) / inner / 1e6
    eps = k["edges"] * NUM_LAYERS / dt
    peaks = {str(d.index): torch.cuda.max_memory_allocated(d) / 2**20
             for d in cards}
    own = {str(d.index): (torch.cuda.max_memory_allocated(d) - base[d])
           / 2**20 for d in cards}
    return {
        "devices": shards, "ms_per_step": dt * 1e3, "edges_per_s": eps,
        "host_ms_per_step": host * 1e3,
        "hardware": device.type,
        "halo_rows_per_shard": int(hedges.halo) * (shards - 1),
        "measures_hardware_scaling":
            len(cards) == shards and device.type == "cuda",
        "exchange": exchange_name(),
        "compute_dtype": "bfloat16" if cd is not None else "float32",
        "device": ra.card_name() if cards else "cpu", "cards": len(cards),
        "peak_mib": max(peaks.values(), default=None),
        "peak_mib_per_card": own or None,
        "cross_card_mb_per_step": crossed / 1e6,
        "peer_copy_mb_per_step": traced,
        "launches_per_step": launches, "device_busy_ms_per_step": busy,
        "step": route, "losses": losses}


def main(argv: Optional[List[str]] = None,
         partitions: Optional[dict] = None) -> List[dict]:
    """Print and return one record per count. ``partitions``: a dict that
    keeps each count's ``(perm, host partition)`` for a later call in the
    same process (the graph and knobs must be the same)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-shards", type=int, default=None,
                    help="the largest count (default: the card count; 1 "
                    "on the CPU)")
    ap.add_argument("--trace", default=None,
                    help="a directory: each count's traced steps and its "
                    "cards' busy ms a step")
    ap.add_argument("--virtual", action="store_true",
                    help="every count as virtual shards of one card")
    args = ap.parse_args(argv)
    k = knobs()
    device = resolve_device(k["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    most = args.max_shards or (torch.cuda.device_count()
                               if device.type == "cuda" else 1)
    counts = [c for c in COUNTS if c <= most]
    partitions = {} if partitions is None else partitions
    log(f"device={device} cards={torch.cuda.device_count()} -> {counts} "
        f"graph={k['graph']} reorder={k['reorder']} "
        f"exchange={exchange_name()} {EAGER_ENV}="
        f"{os.environ.get(EAGER_ENV)!r}")
    src, dst, typ, slots = graph(k)
    records, base_eps = [], None
    for c in counts:
        if c not in partitions:
            t0 = time.perf_counter()
            partitions[c] = partition(src, dst, typ, k["nodes"], slots, c,
                                      k["reorder"])
            log(f"  {c} shards: reorder and partition "
                f"{time.perf_counter() - t0:.1f}s")
        rec = measure(k, c, *partitions[c], slots, device, args.trace,
                      args.virtual)
        base_eps = base_eps or rec["edges_per_s"]
        rec["efficiency"] = rec["edges_per_s"] / (base_eps * c)
        rec["throughput_retention"] = rec["edges_per_s"] / base_eps
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
