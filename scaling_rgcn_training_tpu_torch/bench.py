"""Benchmark: edges/s for the 2-layer R-GCN train step (forward, backward
and Adam) on one card.

Counterpart of the JAX package's root ``bench.py``:

    python -m scaling_rgcn_training_tpu_torch.bench

Prints ONE JSON line last, with the JAX line's keys:

- ``value``: edge traversals per second (E x 2 layers / step time) of the
  train step through ``rgcn_conv``'s ``mode="auto"``, which takes the span
  kernels (#1 ``span_forward``, #2 ``span_backward``) on both layers, as
  the JAX bench's ``auto`` takes its fused kernels;
- ``vs_baseline``: the speedup over the reference *design* on the same
  card and graph, PyG ``RGCNConv``'s per-relation loop (one masked pass a
  relation: gather, scale, ``index_add_`` onto ``[N, d]``, then a dense
  matmul), written in plain PyTorch in the same compute dtype;
- ``ms_per_step``, ``baseline_ms_per_step``, ``compute_dtype``;
- ``hbm_bytes_per_step_est`` and ``achieved_gbps_est``: the bytes the span
  kernels' functions must move (``span_kernels.forward_cost`` and
  ``backward_cost`` of both layers, each input read once and each output
  written once) plus the JAX line's node-sized ``10 N d`` float32 (outputs,
  dx, parameters, Adam's moments), over the step time. The JAX figure
  counts each layer's edge streams twice, as gathers materialised in HBM
  on the TPU; the port's kernels gather inside, so the two estimates
  differ by design.

and four keys of the port's own: ``device`` (``nvidia-smi``'s name and
power limit of the card, ``cpu`` on the CPU), ``peak_mib`` (peak device
memory of the timed run), ``launches_per_step`` (each kernel wrapper's
launches over the timed calls, ``cuda_build.LAUNCHES``, per step: #1 and
#2 at 2, every other at 0) and ``step`` (the route of the step:
``"graph"``, captured once as a CUDA graph and replayed, as the JAX
bench's steps run in one jitted ``lax.scan``, or ``"eager"``: the CPU, or
``RGCN_EAGER_STEP`` set; ``train/step_graph.py``).

The graph is the JAX bench's, drawn from one ``np.random.default_rng(0)``
in its order: ``src``, ``dst``, the relation in ``[0, 2R)`` (slot ``2R``
of the ``2R + 1`` stays empty), then the labelled rows
``rng.choice(N, min(4096, N // 2), replace=False)`` with one-hot labels
``i % C``. Not ``bench_shape.bench_edges``, whose relations fill all
``2R + 1`` slots and whose split comes from seed 1. The model is
``init_emb_model`` from ``torch.Generator`` seed 0, the optimizer Adam
0.01 with the coupled L2 5e-5 (``train/optim.py``); a step is the
forward, BCE on the labelled rows, the backward and Adam, with no
validation forward.

Timing (``rehearse_am.train``): a call is ``BENCH_INNER`` chained steps
with one synchronisation at its end; the first call warms up (on the
card: the eager warm-up steps and the capture; the baseline loop is
captured the same way); the result
is the best of ``BENCH_STEPS`` calls over ``BENCH_INNER``, and the
baseline's the best of ``max(1, BENCH_STEPS // 3)``.

Env knobs (the JAX bench's, with its defaults): ``BENCH_NODES``
(200,000), ``BENCH_EDGES`` (4,000,000), ``BENCH_RELS`` (45), ``BENCH_DIM``
(64), ``BENCH_HIDDEN`` (16), ``BENCH_STEPS`` (8), ``BENCH_INNER`` (40),
``BENCH_BACKEND`` (``ragged``: the grouped matmul of ``rgcn_conv``'s
non-fused dataflows, which these widths do not take),
``BENCH_COMPUTE_DTYPE`` (``bfloat16``; ``float32``), ``BENCH_SKIP_BASELINE``
and ``BENCH_BASELINE_MS`` (skip the loop; take this time, or the step's);
and ``BENCH_DEVICE`` (``cuda``: raises without a card; ``cpu`` runs the
kernels' plain versions, for tests).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch import rehearse_am as ra
from scaling_rgcn_training_tpu_torch.ops import span_kernels
from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    RelEdges, RGCNLayer, build_rel_edges, materialize_weight, rgcn_conv)
from scaling_rgcn_training_tpu_torch.train.step_graph import (
    describe, step_route)

METRIC = "rgcn_train_step_edge_traversals_per_second_per_chip"
CLASSES = 8
NUM_LAYERS = 2
LR, WEIGHT_DECAY = 0.01, 5e-5


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def compute_dtype(value: str):
    """``(torch dtype or None, name)`` of a ``BENCH_COMPUTE_DTYPE`` value,
    with the JAX bench's spellings and error."""
    v = value.strip().lower()
    if v in ("", "float32", "f32", "fp32", "none"):
        return None, "float32"
    if v in ("bfloat16", "bf16"):
        return torch.bfloat16, "bfloat16"
    raise SystemExit(f"BENCH_COMPUTE_DTYPE={v!r} not recognized; "
                     "use float32/f32/fp32/none or bfloat16/bf16")


def knobs() -> Dict[str, object]:
    env = os.environ
    cd, cd_name = compute_dtype(env.get("BENCH_COMPUTE_DTYPE", "bfloat16"))
    return {"nodes": int(env.get("BENCH_NODES", 200_000)),
            "edges": int(env.get("BENCH_EDGES", 4_000_000)),
            "rels": int(env.get("BENCH_RELS", 45)),
            "dim": int(env.get("BENCH_DIM", 64)),
            "hidden": int(env.get("BENCH_HIDDEN", 16)),
            "steps": int(env.get("BENCH_STEPS", 8)),
            "inner": int(env.get("BENCH_INNER", 40)),
            "backend": env.get("BENCH_BACKEND", "ragged"),
            "compute_dtype": cd, "dtype_name": cd_name,
            "skip_baseline": bool(env.get("BENCH_SKIP_BASELINE")),
            "baseline_ms": float(env.get("BENCH_BASELINE_MS", 0)),
            "device": env.get("BENCH_DEVICE", "cuda")}


def bench_graph(n: int, e: int, r: int):
    """``(src, dst, typ, slots, x_train, y_train)``: the JAX bench's
    draws from ``default_rng(0)`` (int32 edges, int64 rows, float32
    one-hot labels)."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)
    n_labeled = min(4096, n // 2)
    x_train = rng.choice(n, n_labeled, replace=False).astype(np.int64)
    y_train = np.eye(CLASSES, dtype=np.float32)[np.arange(n_labeled)
                                                % CLASSES]
    return src, dst, typ, 2 * r + 1, x_train, y_train


def resolve_device(name: str) -> torch.device:
    if name.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("BENCH_DEVICE=cuda: no CUDA device here (set "
                           "BENCH_DEVICE=cpu for the plain versions)")
    return torch.device(name)


def build(k: Dict[str, object], device):
    """The bench graph's edges with the span plan on ``device``, the
    labelled rows and their targets, and the slot count."""
    src, dst, typ, slots, x_train, y_train = bench_graph(
        k["nodes"], k["edges"], k["rels"])
    edges = build_rel_edges(src, dst, typ, k["nodes"], slots, device=device)
    return (edges, torch.as_tensor(x_train).to(device),
            torch.as_tensor(y_train).to(device), slots)


def init_model(k: Dict[str, object], slots: int, device, params=None):
    """``rehearse_am.init_model`` at the bench's widths and classes."""
    from scaling_rgcn_training_tpu_torch.models.heads import (
        emb_model_from_numpy, init_emb_model)

    if params is not None:
        return emb_model_from_numpy(*params, device=device)
    return init_emb_model(torch.Generator().manual_seed(0), slots,
                          k["hidden"], CLASSES, k["nodes"], k["dim"],
                          device=device)


def baseline_conv_layer(x: torch.Tensor, edges: RelEdges, layer: RGCNLayer,
                        cd: Optional[torch.dtype]) -> torch.Tensor:
    """PyG ``RGCNConv``'s structure (the JAX bench's ``rgcn_conv_loop``):
    the root and bias term in float32, then one pass a relation over its
    edges, ``x[src] * norm`` in ``cd``, ``index_add_`` onto ``[N, d_in]``
    in ``cd``, ``@ w[rel]`` in ``cd``, added in float32."""
    cd = cd or x.dtype
    w = materialize_weight(layer).to(cd)
    out = (x @ layer.root + layer.bias).float()
    xc = x.to(cd)
    norm = edges.norm.to(cd)
    offs = edges.group_offsets
    for rel in range(edges.num_slots):
        lo, hi = offs[rel], offs[rel + 1]
        if hi == lo:
            continue
        msg = xc.index_select(0, edges.src[lo:hi]) * norm[lo:hi, None]
        agg = torch.zeros(edges.num_nodes, xc.shape[1], dtype=cd,
                          device=xc.device).index_add(0, edges.dst[lo:hi], msg)
        out = out + (agg @ w[rel]).float()
    return out


def step_conv(edges: RelEdges, k: Dict[str, object], baseline: bool = False):
    """``conv(x, layer)`` of the timed step, or of the baseline loop."""
    cd = k["compute_dtype"]
    if baseline:
        return lambda x, layer: baseline_conv_layer(x, edges, layer, cd)
    return lambda x, layer: rgcn_conv(x, edges, layer, backend=k["backend"],
                                      compute_dtype=cd)


def run(k: Dict[str, object], edges: RelEdges, rows, targets, slots: int,
        calls: int, baseline: bool = False, params=None) -> dict:
    """``rehearse_am.train`` of the bench's model from seed 0 (or from
    ``params``, the JAX leaves as numpy): a first call and ``calls`` timed
    calls of ``k["inner"]`` steps. Adds ``ms_per_step``, the best call's ms
    over its steps."""
    model = init_model(k, slots, edges.src.device, params)
    res = ra.train(model.embedding, (model.rgcn1, model.rgcn2),
                   step_conv(edges, k, baseline), rows, targets,
                   WEIGHT_DECAY, k["inner"], calls)
    res["ms_per_step"] = min(res["call_ms"]) / k["inner"] \
        if res["call_ms"] else None
    return res


def hbm_bytes(edges: RelEdges, k: Dict[str, object]) -> int:
    """The step's byte estimate: each layer's ``forward_cost`` and
    ``backward_cost`` bytes on the bench's shapes and dtype, plus the JAX
    line's node-sized ``10 N d`` float32."""
    dt = k["compute_dtype"] or torch.float32
    meta = lambda *shape: torch.empty(shape, dtype=dt, device="meta")
    n, slots, plan = edges.num_nodes, edges.num_slots, edges.span
    total = 10 * n * k["dim"] * 4
    for d_in, d_out in ((k["dim"], k["hidden"]), (k["hidden"], CLASSES)):
        x, w, g = meta(n, d_in), meta(slots, d_in, d_out), meta(n, d_out)
        total += span_kernels.forward_cost(x, w, plan)[0]
        total += span_kernels.backward_cost(g, x, w, plan)[0]
    return int(total)


def launches_per_step(res: dict, inner: int) -> Dict[str, float]:
    """Each wrapper's launches over the timed calls, per step."""
    timed = res["launches"][inner:]
    return {name: sum(st[name] for st in timed) / max(len(timed), 1)
            for name in LAUNCHES}


def main() -> dict:
    k = knobs()
    device = resolve_device(k["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    n, e, inner = k["nodes"], k["edges"], k["inner"]
    log(f"bench: device={device} card={ra.card_name()} "
        f"step={describe(step_route([device]))}")
    log(f"graph: N={n} E={e} R={k['rels']} d={k['dim']} hl={k['hidden']} "
        f"dtype={k['dtype_name']}")
    edges, rows, targets, slots = build(k, device)

    opt = run(k, edges, rows, targets, slots, k["steps"])
    t_opt = opt["ms_per_step"] / 1e3
    edges_per_s = e * NUM_LAYERS / t_opt
    log(f"  first call: {opt['first_call_s']:.1f}s")
    log(f"optimized: {t_opt * 1e3:.3f} ms/step  "
        f"{edges_per_s / 1e6:.1f} M edge-traversals/s  "
        f"loss={opt['losses'][-1]!r}")

    if k["skip_baseline"]:
        t_base = k["baseline_ms"] / 1e3 or t_opt
    else:
        base = run(k, edges, rows, targets, slots, max(1, k["steps"] // 3),
                   baseline=True)
        t_base = base["ms_per_step"] / 1e3
        log(f"baseline(loop): {t_base * 1e3:.3f} ms/step  "
            f"loss={base['losses'][-1]!r}")

    n_bytes = hbm_bytes(edges, k)
    rec = {
        "metric": METRIC,
        "value": edges_per_s,
        "unit": "edges/s/chip",
        "vs_baseline": t_base / t_opt,
        "compute_dtype": k["dtype_name"],
        "ms_per_step": t_opt * 1e3,
        "baseline_ms_per_step": t_base * 1e3,
        "hbm_bytes_per_step_est": n_bytes,
        "achieved_gbps_est": n_bytes / t_opt / 1e9,
        "device": ra.card_name() if device.type == "cuda" else "cpu",
        "peak_mib": opt["peak_mib"],
        "launches_per_step": launches_per_step(opt, inner),
        "step": opt["step"],
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
