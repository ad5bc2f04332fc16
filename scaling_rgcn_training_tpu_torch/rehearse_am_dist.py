"""AM-scale distributed rehearsal: the halo partition at S = 8 with its
traffic model, the plan cache's cold and warm seconds, and the halo train
step executed over 8 virtual shards of one card.

Counterpart of the JAX package's ``scripts/rehearse_am_dist.py``, at the AM
shape of ``rehearse_am.py`` (N 1,600,000, E 12,000,000, 133 relations ->
267 slots, 64 -> 16 -> 11):

    python -m scaling_rgcn_training_tpu_torch.rehearse_am_dist \\
        [--device cuda|cpu]

1. Traffic model. A uniform graph and an SBM-style one (512 communities,
   90% of the edges inside one), each without and with
   ``parallel/reorder.py`` ``locality_reorder``, go through
   ``halo_partition_edges(..., S=8, pad_to_multiple=512)``: H (the padded
   rows a shard ships each peer), the true boundary rows (unique (reader
   shard, remote source row) pairs: what must cross, before padding), and
   the wire model ``2 x (S-1) x H x (d + hl) x 2`` bytes a step and device
   (one all-to-all of bfloat16 rows per conv layer forward and its reverse
   in the backward). The wire bytes are a model of a layout over 8 cards,
   not a measurement: this run has one card.
2. Plan cache. The uniform graph's partition built cold into
   ``AM_DIST_PLAN_CACHE`` and loaded from it.
3. Executed step (``AM_STEP``, on unless 0). At ``AM_STEP_SCALE`` of the
   shape (default 1.0, the full shape: the JAX script's 0.5 was the
   ceiling of its CPU emulation, not of the program), the halo partition
   over 8 virtual shards of the card (``parallel/mesh.py`` ``make_mesh``,
   as ``chip_smoke.py`` phase 8), or with ``--cards [C]`` the JAX
   script's ``make_mesh(8)`` over C cards (every visible card without a
   value), 8 / C shards a card: a N(0, 1) embedding of the padded rows
   node-sharded (``node_sharding``: one Parameter a shard on its card,
   Adam's moments with it),
   two ``init_rgcn_layer`` layers, Adam 0.01 with no L2, labels on rows
   ``0 .. 8191`` (class ``i % 11``), ``halo_rgcn_conv`` twice, edge streams
   in bfloat16, ``STEPS`` steps (on the card after 2 eager steps a
   captured CUDA graph replayed, ``train/step_graph.py``; ``step`` in the
   record names the route). The exchange is the one
   ``RGCN_HALO_PALLAS_A2A`` picks (unset: the library copies; ``1``:
   kernel #6; ``fused``: kernel #7).

The graphs come from one ``np.random.default_rng(0)`` in the script's
order (the relation of every edge; then ``gen("uniform")`` and
``gen("sbm")`` for the arms, ``gen("uniform")`` for the plan cache and
``gen("uniform")`` for the executed step), so both packages build the
same arrays.

Knobs: ``AM_NODES``, ``AM_EDGES``, ``AM_RELS``, ``AM_DIM``, ``AM_HIDDEN``
(as ``rehearse_am.py``), ``AM_STEP``, ``AM_STEP_SCALE``,
``AM_DIST_PLAN_CACHE`` (default: a temporary directory, removed at the
end) and ``AM_DIST_OUT`` (a path: the record is also written there;
unset, no file is written). Prints one JSON record, the script's keys
and, in the executed step's, the card, the cards, the exchange, ms per
step (median of the steps after the first), peak device memory (the
largest card's, and each card's) and peak host RSS.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from scaling_rgcn_training_tpu_torch import bench_shape as bs
from scaling_rgcn_training_tpu_torch import rehearse_am

S = 8
# bytes of a halo row's element on the wire (bfloat16 streams)
ESIZE = 2
STEPS = 10
PAD_TO_MULTIPLE = 512
WIRE_MODEL = ("2 dirs x (S-1) x H x (d_l1 + d_l2) x 2B (one all_to_all per "
              "conv layer fwd + reverse in bwd): a model of a layout over "
              "S cards, not a measurement")


def knobs() -> Dict[str, object]:
    env = os.environ
    k = rehearse_am.knobs()
    k.update(step=env.get("AM_STEP", "1") != "0",
             step_scale=float(env.get("AM_STEP_SCALE", 1.0)),
             plan_cache=env.get("AM_DIST_PLAN_CACHE") or None)
    return k


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def relations(rng, k: Dict[str, object]) -> np.ndarray:
    """The relation of every edge: the script's first draw."""
    return rng.integers(0, 2 * k["rels"], k["edges"]).astype(np.int32)


def gen(rng, kind: str, n: int, e: int):
    """``(src, dst)`` int32 of a ``"uniform"`` graph or an ``"sbm"`` one
    (512 communities, 90% of the edges inside one), drawn from ``rng`` as
    the script draws them."""
    if kind == "uniform":
        return (rng.integers(0, n, e).astype(np.int32),
                rng.integers(0, n, e).astype(np.int32))
    n_comm, p_in = 512, 0.9
    comm = rng.integers(0, n_comm, n)
    order_c = np.argsort(comm, kind="stable")
    csize = np.bincount(comm, minlength=n_comm)
    coff = np.concatenate([[0], np.cumsum(csize)])
    intra = rng.random(e) < p_in
    ei = int(intra.sum())
    ci = rng.integers(0, n_comm, ei)

    def pick():
        return order_c[coff[ci] + (rng.random(ei) * csize[ci]).astype(np.int64)]

    src = np.empty(e, np.int64)
    dst = np.empty(e, np.int64)
    src[intra], dst[intra] = pick(), pick()
    m = e - ei
    src[~intra] = rng.integers(0, n, m)
    dst[~intra] = rng.integers(0, n, m)
    return src.astype(np.int32), dst.astype(np.int32)


def true_boundary_rows(src: np.ndarray, dst: np.ndarray, n_per: int,
                       n: int) -> int:
    """Unpadded count of (reader shard, remote src row) pairs: the rows
    that must cross between shards a layer, before halo padding."""
    so = src.astype(np.int64) // n_per
    do = dst.astype(np.int64) // n_per
    cross = so != do
    return int(len(np.unique(do[cross] * (n + 1)
                             + src[cross].astype(np.int64))))


def partition(src, dst, typ, n: int, slots: int, cache_dir=None):
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        halo_partition_edges)

    return halo_partition_edges(src, dst, typ, n, slots, S,
                                pad_to_multiple=PAD_TO_MULTIPLE,
                                cache_dir=cache_dir)


def traffic_arm(kind: str, reorder: bool, src0, dst0, typ,
                k: Dict[str, object]):
    """``(arm, host partition)`` of one graph: H, the true boundary rows,
    the wire model's bytes and the reorder's and partition's seconds."""
    from scaling_rgcn_training_tpu_torch.parallel.reorder import (
        locality_reorder)

    n, slots = k["nodes"], 2 * k["rels"] + 1
    src, dst = src0, dst0
    t0 = time.perf_counter()
    if reorder:
        perm = locality_reorder(src0, dst0, n, num_shards=S)
        src, dst = perm[src0], perm[dst0]
    t_reorder = time.perf_counter() - t0
    t0 = time.perf_counter()
    hedges = partition(src, dst, typ, n, slots)
    t_plan = time.perf_counter() - t0
    h = int(hedges.halo)
    true_rows = true_boundary_rows(src, dst, -(-n // S), n)
    wire = 2 * (S - 1) * h * (k["dim"] + k["hidden"]) * ESIZE
    arm = {"graph": kind, "reorder": reorder,
           "halo_rows_padded_per_peer": h,
           "halo_rows_padded_per_device": (S - 1) * h,
           "true_boundary_rows_total": true_rows,
           "true_boundary_rows_per_device_avg": true_rows / S,
           "wire_bytes_per_step_per_device": wire,
           "wire_MB_per_step_per_device": wire / 1e6,
           "plan_build_s": t_plan, "reorder_s": t_reorder}
    log(f"  {kind} reorder={reorder}: H={h}/peer ({wire / 1e6:.2f} MB/step/"
        f"dev wire, modelled), reorder {t_reorder:.1f}s, plan {t_plan:.1f}s")
    return arm, hedges


def reorder_effect(arms: List[dict]) -> Dict[str, float]:
    """Per graph kind, the reordered arm's wire bytes over the plain arm's."""
    eff = {}
    for kind in ("uniform", "sbm"):
        base, reo = (next(a for a in arms if a["graph"] == kind
                          and a["reorder"] == r) for r in (False, True))
        eff[kind] = (reo["wire_bytes_per_step_per_device"]
                     / base["wire_bytes_per_step_per_device"])
    return eff


def plan_cache_timing(src, dst, typ, n: int, slots: int,
                      cache_dir: str) -> Dict[str, float]:
    """Seconds of the partition built cold into ``cache_dir``, then loaded
    from it."""
    t0 = time.perf_counter()
    partition(src, dst, typ, n, slots, cache_dir)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    partition(src, dst, typ, n, slots, cache_dir)
    return {"cold_s": cold, "hit_s": time.perf_counter() - t0}


def make_params(n_pad: int, k: Dict[str, object], slots: int):
    """``(embedding [n_pad, d], layer 1, layer 2)`` on the CPU: the
    embedding N(0, 1) from ``torch.Generator`` seed 0, the layers
    ``init_rgcn_layer`` from seeds 1 and 2 (the script's keys 0, 1, 2)."""
    import torch

    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import init_rgcn_layer

    gen = lambda seed: torch.Generator().manual_seed(seed)
    emb = torch.randn((n_pad, k["dim"]), generator=gen(0))
    return (emb, init_rgcn_layer(gen(1), slots, k["dim"], k["hidden"]),
            init_rgcn_layer(gen(2), slots, k["hidden"], bs.AM_C))


def step_labels(n: int, device):
    """Rows ``0 .. min(8192, n) - 1`` and one-hot targets ``i % 11``."""
    import torch

    count = min(bs.AM_LABELLED, n)
    rows = torch.arange(count, device=device)
    y = torch.eye(bs.AM_C)[torch.arange(count) % bs.AM_C].to(device)
    return rows, y


def shard_devices(device, cards: Optional[int] = None) -> tuple:
    """The ``S`` shards' devices: ``S`` virtual shards of ``device``
    (``cards`` None), or the JAX script's ``make_mesh(S)`` over the first
    ``cards`` cards, ``S / cards`` a card (shard ``s`` on card ``s // (S /
    cards)``; 8 over 4 gives 2 a card). Raises when the cards are missing
    or do not divide ``S``."""
    import torch

    if not cards:
        return (device,) * S
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards > have or S % cards:
        raise RuntimeError(f"--cards {cards}: {S} shards over {cards} of "
                           f"{have} cards (the cards must divide {S})")
    return tuple(torch.device("cuda", s // (S // cards)) for s in range(S))


def run_loop(params, conv, device, steps: int, mesh=None) -> dict:
    """``steps`` steps of the step's loop from copies of ``params``
    (``rehearse_am.train`` with one step a call, no L2): on ``device``, or
    with a ``mesh`` the embedding node-sharded over it (one Parameter a
    shard, ``node_sharding``), the layers and the labels on its first
    device and each shard's labelled rows picked where they lie. The
    losses, the first step's seconds, ms per step (median of the steps
    after the first), peak device memory (and each card's) and each
    step's launches."""
    import torch

    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer
    from scaling_rgcn_training_tpu_torch.parallel.mesh import (
        node_sharding, row_pick)

    emb, l1, l2 = params
    home = device if mesh is None else mesh.first
    layers = [RGCNLayer(*[p.detach().clone().to(home)
                          for p in (l.weight, l.root, l.bias)])
              for l in (l1, l2)]
    rows, y = step_labels(emb.shape[0], home)
    if mesh is None:
        emb = torch.nn.Parameter(emb.clone().to(device))
    else:
        emb = node_sharding(emb, mesh).as_parameters()
        rows = row_pick(rows.cpu().numpy(), emb.n_per, mesh.devices)
    res = rehearse_am.train(emb, layers, conv, rows, y, 0.0, 1, steps - 1)
    res["first_step_s"] = res.pop("first_call_s")
    res["ms_per_step"] = statistics.median(res["call_ms"]) \
        if res["call_ms"] else None
    return res


def halo_conv(hedges, mesh, compute_dtype):
    from scaling_rgcn_training_tpu_torch.parallel.halo import halo_rgcn_conv

    return lambda x, layer: halo_rgcn_conv(x, hedges, layer, mesh,
                                           compute_dtype=compute_dtype)


def unpartitioned_conv(src, dst, typ, n_pad: int, slots: int, device,
                       compute_dtype):
    """The fused conv over the same graph in one piece (``n_pad`` nodes,
    the padding rows isolated), for the comparison with the halo step."""
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
        build_rel_edges, rgcn_conv)

    edges = build_rel_edges(src, dst, typ, n_pad, slots, device=device)
    return lambda x, layer: rgcn_conv(x, edges, layer, mode="fused",
                                      compute_dtype=compute_dtype)


def executed_step(src, dst, typ, k: Dict[str, object], device, steps: int,
                  compute_dtype, scale: float, cards: Optional[int] = None,
                  host=None) -> dict:
    """The executed step's record: the partition of ``(src, dst, typ)``
    (``host``: that partition, already built) over ``S`` shards
    (:func:`shard_devices`: virtual shards of ``device``, or ``S / cards``
    on each of ``cards`` cards), ``steps`` steps."""
    import torch

    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        device_put_halo_edges, exchange_name, padded_num_nodes)
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

    n, slots = int(k["nodes"] * scale), 2 * k["rels"] + 1
    mesh = make_mesh(devices=shard_devices(device, cards))
    t0 = time.perf_counter()
    if host is None:
        host = partition(src, dst, typ, n, slots)
    hedges = device_put_halo_edges(host, mesh)
    plan_s = time.perf_counter() - t0
    params = make_params(padded_num_nodes(hedges), k, slots)
    res = run_loop(params, halo_conv(hedges, mesh, compute_dtype), device,
                   steps, mesh)
    return {
        "devices": S, "cards": len(set(mesh.devices)),
        "hardware": device.type,
        "card": rehearse_am.card_name() if device.type == "cuda" else None,
        "nodes": n, "edges": int(src.shape[0]), "scale_of_am": scale,
        "exchange": exchange_name(),
        "compute_dtype": str(compute_dtype or torch.float32)[6:],
        "plan_build_s": plan_s, "first_step_s": res["first_step_s"],
        "ms_per_step": res["ms_per_step"], "steps": steps,
        "step": res["step"], "losses": res["losses"],
        "loss_finite": bool(np.isfinite(res["losses"]).all()),
        "peak_device_memory_mib": res["peak_mib"],
        "peak_mib_per_card": res["peak_mib_per_card"],
        "peak_host_rss_gib": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024 / 2**30,
        "launches": {n_: sum(st[n_] for st in res["launches"])
                     for n_ in rehearse_am.COUNTED}}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cards", type=int, nargs="?", const=0, default=None,
                    help="the executed step's S shards over this many "
                    "cards, S / cards a card (no value: every visible "
                    "card); default: S virtual shards of one")
    args = ap.parse_args(argv)
    import torch

    device = rehearse_am.resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    k = knobs()
    n, e, slots = k["nodes"], k["edges"], 2 * k["rels"] + 1
    log(f"AM dist rehearsal: N={n} E={e} R={k['rels']} S={S} "
        f"device={device}")
    rng = np.random.default_rng(0)
    typ = relations(rng, k)
    arms = []
    for kind in ("uniform", "sbm"):
        src0, dst0 = gen(rng, kind, n, e)
        for reorder in (False, True):
            arms.append(traffic_arm(kind, reorder, src0, dst0, typ, k)[0])

    src0, dst0 = gen(rng, "uniform", n, e)
    with tempfile.TemporaryDirectory() as tmp:
        cache = plan_cache_timing(src0, dst0, typ, n, slots,
                                  k["plan_cache"] or tmp)
    log(f"plan cache: cold {cache['cold_s']:.1f}s -> hit "
        f"{cache['hit_s']:.1f}s")

    executed = None
    if k["step"]:
        scale = k["step_scale"]
        n_s, e_s = int(n * scale), int(e * scale)
        src_s, dst_s = gen(rng, "uniform", n, e)
        src_s, dst_s = src_s[:e_s] % n_s, dst_s[:e_s] % n_s
        cards = args.cards
        if cards == 0:
            cards = torch.cuda.device_count()
        executed = executed_step(src_s, dst_s, typ[:e_s], k, device, STEPS,
                                 torch.bfloat16, scale, cards)
        log(f"executed step ({executed['exchange']}): first "
            f"{executed['first_step_s']:.1f}s, {executed['ms_per_step']} "
            f"ms/step, loss finite {executed['loss_finite']}, peak "
            f"{executed['peak_device_memory_mib']} MiB")

    rec = {
        "config": "AM-scale synthetic, node-partitioned halo, S=8",
        "nodes": n, "edges": e, "relations": k["rels"], "emb_dim": k["dim"],
        "hidden": k["hidden"], "halo_dtype": "bfloat16",
        "traffic_model": arms, "reorder_wire_ratio": reorder_effect(arms),
        "wire_model": WIRE_MODEL, "plan_cache": cache,
        "executed_step": executed,
        "reference_anchor": rehearse_am.REFERENCE_ANCHOR}
    print(json.dumps(rec), flush=True)
    out = os.environ.get("AM_DIST_OUT")
    if out:
        with open(out, "w") as fh:
            json.dump(rec, fh, indent=2)
    return rec


if __name__ == "__main__":
    main()
