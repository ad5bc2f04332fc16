"""AM-scale rehearsal: the embedding model's train step at the AM shape on
one card.

Counterpart of the JAX package's ``scripts/rehearse_am.py``. AM is the
reference's largest dataset (~1.6M entities, ~6M triples -> 12M directed
edges after the inverse-relation doubling, 133 relations -> 267 weight
slots). Its ``.nt`` file is absent, so this rehearses the shape: a
uniform random graph drawn from ``np.random.default_rng(0)`` as the script
draws it (``src``, ``dst``, then the relation over ``2R``), the 2-layer
R-GCN 64 -> 16 -> 11, 8,192 labelled rows drawn after the edges
(``rng.choice(N, 8192, replace=False)``) with one-hot labels cycling over
the 11 classes, BCE on those rows, Adam 0.01 with coupled L2 5e-5, edge
streams in bfloat16 with float32 sums (``--dtype``).

    python -m scaling_rgcn_training_tpu_torch.rehearse_am \\
        [--device cuda|cpu] [--dtype bfloat16|float32] [--mode fused|edge]

Knobs, the script's: ``AM_NODES`` (1,600,000), ``AM_EDGES`` (12,000,000),
``AM_RELS`` (133), ``AM_DIM`` (64), ``AM_HIDDEN`` (16), ``AM_INNER`` (5),
``AM_CALLS`` (3), ``AM_PLAN_CACHE`` (a plan-cache directory: the second run
loads the plan) and ``AM_OUT`` (a path: the record is also written there;
unset, no file is written).

A first call of ``AM_INNER`` steps (the kernels' first launches), then
``AM_CALLS`` calls of ``AM_INNER`` steps, the card synchronised at the end
of each call; ``ms_per_step`` is the timed calls' time over their steps,
as the script's. ``--mode``: ``fused`` (kernels #1 and #2) or ``edge``
(``backend="pallas"``: #3, #4 and #5). The port's edge plan takes no
padding (the TPU plan's ``pad_to_multiple`` is a TPU layout): its
``padded_edges`` is E. The record has the script's keys, plus ``card``
(name and power limit), ``peak_memory_mib``, ``peak_reserved_mib`` (the
allocator's reserved peak: a captured step's private pool shows there),
``conv_mode``, ``first_call_s``, ``host_ms_per_step`` (the timed
calls' issue time before their synchronisation, over their steps),
``step`` (the route of the step,
``"graph"``: captured once as a CUDA graph and replayed, or ``"eager"``;
``train/step_graph.py``, ``RGCN_EAGER_STEP``) and ``launches`` (each
kernel's launches over the run).
``--device cuda`` (the default) raises on a machine with no card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from scaling_rgcn_training_tpu_torch import bench_shape as bs

LR = 0.01
WEIGHT_DECAY = 5e-5
REFERENCE_ANCHOR = ("AM baseline 90.48% @ 101 epochs "
                    "(baselines/AM_baseline/report_baseline_i=5.json)")
# the kernels whose launches a record counts
COUNTED = ("span_forward", "span_backward", "segment_sum", "grouped_matmul",
           "grouped_drhs", "halo_exchange", "fused_halo_aggregate")


def knobs() -> Dict[str, object]:
    env = os.environ
    return {"nodes": int(env.get("AM_NODES", bs.AM_N)),
            "edges": int(env.get("AM_EDGES", bs.AM_E)),
            "rels": int(env.get("AM_RELS", bs.AM_R)),
            "dim": int(env.get("AM_DIM", bs.AM_D)),
            "hidden": int(env.get("AM_HIDDEN", bs.AM_HL)),
            "inner": int(env.get("AM_INNER", 5)),
            "calls": int(env.get("AM_CALLS", 3)),
            "plan_cache": env.get("AM_PLAN_CACHE") or None}


def card_name() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def resolve_device(name: str):
    import torch

    if name.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here (pass "
                           "--device cpu for the plain versions)")
    return torch.device(name)


def am_graph(k: Dict[str, object]):
    """``(src, dst, typ, slots, rng)``: the script's draws from
    ``default_rng(0)``; ``rng`` goes on to draw the labelled rows."""
    n, e, r = k["nodes"], k["edges"], k["rels"]
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)
    return src, dst, typ, 2 * r + 1, rng


def am_labels(rng, n: int, classes: int):
    """The labelled rows (``rng.choice(n, 8192, replace=False)``; every
    row where ``n < 8192``) and their one-hot targets, class
    ``i % classes``."""
    count = min(bs.AM_LABELLED, n)
    rows = rng.choice(n, count, replace=False).astype(np.int64)
    return rows, np.eye(classes, dtype=np.float32)[np.arange(count) % classes]


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(emb, layers: Sequence, conv: Callable, rows, targets,
          weight_decay: float, inner: int, calls: int,
          on_step: Optional[Callable[[int], None]] = None) -> dict:
    """``(1 + calls) * inner`` train steps of ``emb -> conv(., layers[0])
    -> ReLU -> conv(., layers[1]) -> BCE on rows -> Adam(LR,
    weight_decay)``, the parameters updated in place (``emb`` a Parameter
    and ``rows`` its labelled rows, or ``emb`` node-sharded,
    ``parallel/mesh.py`` ``NodeRows`` of Parameters, and ``rows`` their
    ``RowPick``); on one card the
    step is captured as a CUDA graph and replayed
    (``train/step_graph.py``: the first call holds the warm-up and the
    capture, as the JAX script's first call holds its compile). The first
    call of ``inner`` steps is timed alone (``first_call_s``); each later
    call's ms (``call_ms``) ends with the card synchronised, and
    ``host_ms`` is the ms its steps took to issue, before that
    synchronisation. Returns the
    loss of every step (before its update), each step's launches of every
    wrapper (``cuda_build.LAUNCHES``), the peak device memory (MiB, the
    largest card's, and ``peak_mib_per_card`` by card index; None on the
    CPU), the peak the allocator reserved (``reserved_mib``: the
    graph's private pool included) and the route that ran (``step``).
    ``on_step(i)`` runs after step ``i`` (``profile_step.py``'s profiler
    steps)."""
    import torch

    from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss
    from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer
    from scaling_rgcn_training_tpu_torch.train.step_graph import (
        CudaStepGraph, StepGraph, step_route)

    from scaling_rgcn_training_tpu_torch.parallel.mesh import NodeRows

    sharded = isinstance(emb, NodeRows)
    devices = emb.devices if sharded else (emb.device,)
    dev = devices[0]
    params = [*(emb.parts if sharded else (emb,)),
              *(p for layer in layers for p in layer.parameters())]
    opt = make_optimizer(params, LR, weight_decay=weight_decay)
    relu = (lambda z: z.map(torch.relu)) if sharded else torch.relu
    take = rows.take if sharded else (lambda t: t.index_select(0, rows))

    def step():
        opt.zero_grad(set_to_none=True)
        z = relu(conv(emb, layers[0]))
        loss = bce_loss(take(conv(z, layers[1])), targets)
        loss.backward()
        opt.step()
        return (loss,)

    route = step_route(devices)
    cards = sorted({d for d in devices if d.type == "cuda"}, key=str)
    launches, call_ms, host_ms = [], [], []
    first_call_s = None
    # an earlier run's optimizer can sit in a reference cycle until the
    # cycle collector runs (bench_scaling.measure): not in this run's peaks
    gc.collect()
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    with StepGraph(step, (1 + calls) * inner, 1, dev,
                   CudaStepGraph(dev) if route == "graph" else None,
                   params=params) as loop:
        for call in range(1 + calls):
            for card in cards:
                sync(card)
            t0 = time.perf_counter()
            for _ in range(inner):
                before = dict(LAUNCHES)
                loop.run()
                launches.append({k: v - before[k] for k, v in LAUNCHES.items()})
                if on_step is not None:
                    on_step(len(launches) - 1)
            issued = time.perf_counter() - t0
            for card in cards:
                sync(card)
            elapsed = time.perf_counter() - t0
            if call == 0:
                first_call_s = elapsed
            else:
                call_ms.append(elapsed * 1e3)
                host_ms.append(issued * 1e3)
        losses = [row[0] for row in loop.rows(0, loop.done)]
    peaks = {str(c.index): torch.cuda.max_memory_allocated(c) / 2**20
             for c in cards}
    reserved = max((torch.cuda.max_memory_reserved(c) / 2**20
                    for c in cards), default=None)
    return {"losses": losses, "launches": launches, "call_ms": call_ms,
            "host_ms": host_ms, "first_call_s": first_call_s,
            "peak_mib": max(peaks.values(), default=None),
            "peak_mib_per_card": peaks or None,
            "reserved_mib": reserved, "step": route}


def build_edges(k: Dict[str, object], device):
    """The AM graph's edges with the span plan on ``device``, the labelled
    rows and targets, the slot count and the plan's build seconds."""
    import torch

    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges

    t0 = time.perf_counter()
    src, dst, typ, slots, rng = am_graph(k)
    edges = build_rel_edges(src, dst, typ, k["nodes"], slots, device=device,
                            cache_dir=k["plan_cache"])
    plan_s = time.perf_counter() - t0
    rows, targets = am_labels(rng, k["nodes"], bs.AM_C)
    return (edges, torch.as_tensor(rows).to(device),
            torch.as_tensor(targets).to(device), slots, plan_s)


def init_model(k: Dict[str, object], slots: int, device, params=None):
    """The embedding model: from ``params`` (the JAX ``EmbModelParams``
    leaves as numpy: ``(embedding, rgcn1, rgcn2)``, each layer
    ``(weight, root, bias)``) or drawn from ``torch.Generator`` seed 0."""
    import torch

    from scaling_rgcn_training_tpu_torch.models.heads import (
        emb_model_from_numpy, init_emb_model)

    if params is not None:
        return emb_model_from_numpy(*params, device=device)
    return init_emb_model(torch.Generator().manual_seed(0), slots,
                          k["hidden"], bs.AM_C, k["nodes"], k["dim"],
                          device=device)


def run(k: Dict[str, object], device, edges, rows, targets, slots: int,
        compute_dtype=None, mode: str = "fused", params=None,
        on_step: Optional[Callable[[int], None]] = None) -> dict:
    """``k["inner"] x (1 + k["calls"])`` steps of the rehearsal's loop on
    placed ``edges``; ``mode`` ``"fused"`` (span kernels) or ``"edge"``
    (``backend="pallas"``). The :func:`train` result, plus
    ``ms_per_step`` (the timed calls' ms over their steps, None with no
    timed call) and ``host_ms_per_step`` (the ms they took to issue)."""
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import rgcn_conv

    if mode not in ("fused", "edge"):
        raise ValueError(f"mode {mode!r}: fused or edge")
    backend = "pallas" if mode == "edge" else None
    model = init_model(k, slots, device, params)

    def conv(x, layer):
        return rgcn_conv(x, edges, layer, backend=backend, mode=mode,
                         compute_dtype=compute_dtype)

    res = train(model.embedding, (model.rgcn1, model.rgcn2), conv, rows,
                targets, WEIGHT_DECAY, k["inner"], k["calls"], on_step)
    steps = k["calls"] * k["inner"]
    res["ms_per_step"] = sum(res["call_ms"]) / steps if steps else None
    res["host_ms_per_step"] = sum(res["host_ms"]) / steps if steps else None
    return res


def memory_record(device) -> dict:
    """The script's ``device_memory`` keys, from PyTorch's allocator."""
    import torch

    if device.type != "cuda":
        return {}
    return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                device).total_memory)}


def record(k: Dict[str, object], edges, res: dict, plan_s: float,
           compute_dtype, mode: str, device) -> dict:
    """The script's record of a run, and the port's keys."""
    dt = res["ms_per_step"]
    return {
        "config": "AM-scale synthetic (BASELINE configs[4] shape analog)",
        "nodes": k["nodes"], "edges": k["edges"], "relations": k["rels"],
        "emb_dim": k["dim"], "hidden": k["hidden"], "ms_per_step": dt,
        "edge_traversals_per_s": k["edges"] * 2 / (dt / 1e3) if dt else None,
        "compute_dtype": str(compute_dtype or "float32").replace("torch.", ""),
        "loss_finite": bool(np.isfinite(res["losses"]).all()),
        "plan_build_s": plan_s, "padded_edges": edges.num_edges,
        "device_memory": memory_record(device),
        "reference_anchor": REFERENCE_ANCHOR,
        "card": card_name() if device.type == "cuda" else None,
        "peak_memory_mib": res["peak_mib"],
        "peak_reserved_mib": res["reserved_mib"], "conv_mode": mode,
        "first_call_s": res["first_call_s"], "step": res["step"],
        "host_ms_per_step": res["host_ms_per_step"],
        "losses": res["losses"],
        "launches": {n: sum(st[n] for st in res["launches"])
                     for n in COUNTED}}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    ap.add_argument("--mode", choices=["fused", "edge"], default="fused")
    args = ap.parse_args(argv)
    import torch

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    k = knobs()
    cd = torch.bfloat16 if args.dtype == "bfloat16" else None
    from scaling_rgcn_training_tpu_torch.train.step_graph import (
        describe, step_route)

    print(f"AM-scale rehearsal: N={k['nodes']} E={k['edges']} R={k['rels']} "
          f"d={k['dim']} hl={k['hidden']} device={device} "
          f"mode={args.mode} dtype={args.dtype} "
          f"step={describe(step_route([device]))}", file=sys.stderr,
          flush=True)
    edges, rows, targets, slots, plan_s = build_edges(k, device)
    print(f"plan build: {plan_s:.1f}s (edges {edges.num_edges})",
          file=sys.stderr, flush=True)
    res = run(k, device, edges, rows, targets, slots, cd, args.mode)
    print(f"first call: {res['first_call_s']:.1f}s", file=sys.stderr,
          flush=True)
    rec = record(k, edges, res, plan_s, cd, args.mode, device)
    print(json.dumps(rec), flush=True)
    out = os.environ.get("AM_OUT")
    if out:
        with open(out, "w") as fh:
            json.dump(rec, fh, indent=2)
    return rec


if __name__ == "__main__":
    main()
