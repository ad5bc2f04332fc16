"""Measure the halo exchange's overlap with the owner-local aggregation.

Port of the JAX package's ``scripts/measure_overlap.py``, and in the same
module the counterpart of its ``scripts/aot_overlap.py``. Two arms, same
program, same mesh:

  overlapped - the shipped dataflow (``parallel/halo.py``): the exchange
               runs on each card's exchange stream while the owner-local
               aggregation runs on the compute stream;
  blocked    - ``RGCN_HALO_BLOCK_OVERLAP=1`` joins before the owner-local
               aggregation, in both directions (the JAX package's
               ``optimization_barrier``).

For each arm: ms per aggregation, forward and forward + backward, each
the best of 3 chained runs of ``OV_INNER`` aggregations after a warm call,
synchronised on every device. On the card, in place of the JAX scripts'
HLO markers and ``aot_overlap``'s ``ops_between_start_done``: one forward
and one backward traced through ``utils/tracing.py``, and from each trace
the compute-stream kernels whose interval meets the exchange stream's work
(its copies, ``halo_pull_kernel``, or NCCL's kernel): the owner-local
segment's kernels that ran while the halo rows were in flight (0 when
blocked). Both arms' outputs and gradients must have the same bits.

Prints the JAX script's lines (``overlapped ... ms/agg``, ``blocked ...``,
``overlap gain: ... ms (...% slower when blocked)``), then one JSON record:
both arms, the window counts, ``halo_rows``, the exchange and the device.

Knobs, as the JAX script's: ``OV_NODES`` (100000), ``OV_EDGES`` (1000000),
``OV_RELS`` (12: 25 slots), ``OV_DIM`` (64), ``OV_OUT`` (16), ``OV_INNER``
(5) and ``OV_DEVICES`` (8 virtual shards of the card); ``--cards`` takes
the visible cards as the shards instead. The graph is uniform from numpy
seed 0, as the JAX script draws it. The exchange is the one
``RGCN_HALO_PALLAS_A2A`` picks: the library exchange or #6 (#7 exchanges
and aggregates in one kernel, overlapped by construction, and has no
arms). ``make_step`` / ``compare_step``: one step of ``multihost_sim``'s
loop (both layers, BCE, backward) in both arms, bit for bit
(``chip_smoke.py`` phase 16 at the bench shape).

Run on the card (the default): ``python -m
scaling_rgcn_training_tpu_torch.measure_overlap [--cards] [--trace DIR]``;
on the CPU (virtual CPU shards, no trace; the times are the CPU's):
``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from scaling_rgcn_training_tpu_torch.bench_scaling import sync
from scaling_rgcn_training_tpu_torch.models.heads import node_rows_from_numpy
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer
from scaling_rgcn_training_tpu_torch.parallel.halo import (
    BLOCK_OVERLAP_ENV, EXCHANGE_ENV, device_put_halo_edges, exchange_mode,
    halo_aggregate, halo_partition_edges, halo_rgcn_conv, padded_num_nodes)
from scaling_rgcn_training_tpu_torch.parallel.mesh import (
    make_mesh, node_sharding, row_pick)
from scaling_rgcn_training_tpu_torch.rehearse_am import card_name
from scaling_rgcn_training_tpu_torch.utils import tracing

ARMS = (("overlapped", False), ("blocked", True))
# RGCN_HALO_PALLAS_A2A of each exchange this script measures
EXCHANGES = {"library": None, "kernel": "1"}
REPEATS = 3


def knobs() -> Dict[str, int]:
    env = os.environ
    return {"nodes": int(env.get("OV_NODES", 100_000)),
            "edges": int(env.get("OV_EDGES", 1_000_000)),
            "rels": int(env.get("OV_RELS", 12)),
            "dim": int(env.get("OV_DIM", 64)),
            "out": int(env.get("OV_OUT", 16)),
            "inner": int(env.get("OV_INNER", 5)),
            "devices": int(env.get("OV_DEVICES", 8))}


@contextlib.contextmanager
def env_set(name: str, value: Optional[str]) -> Iterator[None]:
    """``name`` set to ``value`` (None: unset) inside the block."""
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def setup(k: Dict[str, int], device: str = "cuda", cards: bool = False
          ) -> Dict[str, Any]:
    """The JAX script's graph and inputs on a mesh: ``OV_DEVICES``
    virtual shards of ``device``, or (``cards``) one shard per visible
    card. ``x`` ``[S * n_per, d]`` (padding rows zero) and the backward's
    upstream gradient ``gout`` node-sharded (``node_sharding``, as the JAX
    script places ``x``), ``w`` ``[slots, d, h]`` * 0.1 on the mesh's
    first device."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: measure_overlap runs on the "
                           "card (--device cpu for the CPU)")
    mesh = make_mesh() if cards else make_mesh(devices=(device,) * k["devices"])
    s_n = mesh.size
    n, e, r, d, h = k["nodes"], k["edges"], k["rels"], k["dim"], k["out"]
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)
    slots = 2 * r + 1
    t0 = time.perf_counter()
    edges = device_put_halo_edges(
        halo_partition_edges(src, dst, typ, n, slots, s_n), mesh)
    build_s = time.perf_counter() - t0
    x = np.zeros((padded_num_nodes(edges), d), np.float32)
    x[:n] = rng.standard_normal((n, d))
    w = (rng.standard_normal((slots, d, h)) * 0.1).astype(np.float32)
    gout = rng.standard_normal((x.shape[0], h)).astype(np.float32)
    return {**k, "mesh": mesh, "plan": edges, "slots": slots, "cards": cards,
            "x": node_sharding(x, mesh),
            "w": torch.tensor(w, device=mesh.first),
            "gout": node_sharding(gout, mesh), "build_s": build_s}


def _best_ms(fn: Callable, devices, inner: int) -> float:
    """The best of ``REPEATS`` synchronised runs of ``fn`` (``inner``
    chained aggregations), ms per aggregation."""
    best = float("inf")
    for _ in range(REPEATS):
        sync(devices)
        t0 = time.perf_counter()
        fn()
        sync(devices)
        best = min(best, (time.perf_counter() - t0) * 1e3 / inner)
    return best


def _window(fn: Callable, trace_dir: str) -> Dict[str, Any]:
    """``fn()`` traced (synchronised on the card): the exchange window of
    its kernels (``utils/tracing.py`` ``stream_overlap``)."""
    with tracing.trace(trace_dir) as prof:
        fn()
        torch.cuda.synchronize()
    events = tracing.gpu_events(prof.trace_path)
    res = tracing.stream_overlap(events)
    if res["window_ms"] <= 0:
        raise RuntimeError(
            f"no exchange-stream work in {prof.trace_path} ({len(events)} "
            f"device events, streams {res['streams']}): the exchange did not "
            "run on its stream, or the profiler kept no device events")
    return res


def describe(win: Dict[str, Any]) -> str:
    """One traced window in words: the compute kernels inside it, the ms
    they overlap of its ms, the windows that ended before the host
    launched the next compute kernel, the card's idle share."""
    idle = 1 - win["busy_ms"] / win["span_ms"] if win["span_ms"] else 0.0
    return (f"{win['inside']} ({win['overlap_ms']:.4f} of "
            f"{win['window_ms']:.4f} ms; host late for "
            f"{win['host_late']}/{win['windows']} windows; idle {idle:.2f})")


def run_arm(s: Dict[str, Any], blocked: bool,
            trace_dir: Optional[str]) -> Dict[str, Any]:
    """One arm: the forward and forward + backward times, one call's
    output and gradients (for the bits), and on the card the traced
    windows of one forward and one backward."""
    mesh, edges, x, w, gout = s["mesh"], s["plan"], s["x"], s["w"], s["gout"]
    devs, inner = mesh.devices, s["inner"]
    xg = x.map(lambda t: t.clone().requires_grad_(True))
    wg = w.clone().requires_grad_(True)
    # each call's input scaled by the previous call's first value, so the
    # calls run in a chain
    chained = lambda rows, c: rows.map(
        lambda t: t * (1 + 1e-12 * c.to(t.device)))

    def grads(out):
        return torch.autograd.grad(out.parts, (*xg.parts, wg), gout.parts)

    def forward(c):
        with torch.no_grad():
            for _ in range(inner):
                c = halo_aggregate(chained(x, c), w, edges,
                                   mesh).parts[0][0, 0]
        return c

    def forward_backward(c):
        for _ in range(inner):
            out = halo_aggregate(chained(xg, c), wg, edges, mesh)
            c = grads(out)[0][0, 0]
        return c

    zero = torch.zeros((), device=mesh.first)
    with env_set(BLOCK_OVERLAP_ENV, "1" if blocked else None):
        sync(devs)
        t0 = time.perf_counter()
        forward(zero)
        sync(devs)
        first_s = time.perf_counter() - t0
        fwd_ms = _best_ms(lambda: forward(zero), devs, inner)
        forward_backward(zero)
        fwd_bwd_ms = _best_ms(lambda: forward_backward(zero), devs, inner)
        out = halo_aggregate(xg, wg, edges, mesh)
        bits = ([p.detach() for p in out.parts], *grads(out))
        window = None
        if trace_dir is not None:
            held = {}

            def fwd():
                held["out"] = halo_aggregate(xg, wg, edges, mesh)

            window = {"forward": _window(fwd, trace_dir),
                      "backward": _window(lambda: grads(held.pop("out")),
                                          trace_dir)}
    return {"ms_per_agg": fwd_ms, "ms_per_agg_fwd_bwd": fwd_bwd_ms,
            "first_call_s": first_s, "window": window, "bits": bits}


def measure(s: Dict[str, Any], exchange: str,
            trace_dir: Optional[str] = None) -> Dict[str, Any]:
    """Both arms with the ``exchange`` (``library`` or ``kernel``, #6) on
    :func:`setup`'s inputs; prints the JAX script's lines and returns the
    record (``same_bits``: both arms' output and gradients)."""
    mesh = s["mesh"]
    card = mesh.first.type == "cuda"
    if card and trace_dir is None:
        raise ValueError("on the card the arms are traced: give a trace_dir")
    with env_set(EXCHANGE_ENV, EXCHANGES[exchange]):
        arms = {name: run_arm(s, blocked, trace_dir if card else None)
                for name, blocked in ARMS}
    bits = [arms[name].pop("bits") for name, _ in ARMS]
    over, block = arms["overlapped"], arms["blocked"]
    kind = torch.cuda.get_device_name(mesh.first) if card else "cpu"
    print(f"device={mesh.first.type} ({kind}) shards={mesh.size} "
          f"cards={s['cards']} N={s['nodes']} E={s['edges']} "
          f"slots={s['slots']} d={s['dim']}->{s['out']} "
          f"halo_rows={s['plan'].halo} "
          f"exchange={exchange}", flush=True)
    for name, _ in ARMS:
        a = arms[name]
        win = a["window"]
        counts = ("local kernels in the exchange window: forward "
                  f"{describe(win['forward'])}, backward "
                  f"{describe(win['backward'])}") if win else \
            "exchange window: not measured (no card)"
        print(f"{name:12s} {a['ms_per_agg']:9.2f} ms/agg  (first call "
              f"{a['first_call_s']:.1f}s)  fwd+bwd "
              f"{a['ms_per_agg_fwd_bwd']:.2f} ms/agg  {counts}", flush=True)
    for tag, key in (("", "ms_per_agg"), (" forward+backward",
                                          "ms_per_agg_fwd_bwd")):
        print(f"overlap gain{tag}: {block[key] - over[key]:.2f} ms "
              f"({(block[key] / over[key] - 1) * 100:.1f}% slower when "
              "blocked)", flush=True)
    return {"device": mesh.first.type, "kind": kind, "shards": mesh.size,
            "cards": s["cards"], "nodes": s["nodes"], "edges": s["edges"],
            "slots": s["slots"], "d_in": s["dim"], "d_out": s["out"],
            "inner": s["inner"], "halo_rows": s["plan"].halo,
            "n_per": s["plan"].n_per, "partition_build_s": s["build_s"],
            "exchange": exchange, "arms": arms,
            "gain_ms": block["ms_per_agg"] - over["ms_per_agg"],
            "gain_ms_fwd_bwd": block["ms_per_agg_fwd_bwd"]
            - over["ms_per_agg_fwd_bwd"],
            "same_bits": tracing.same_bits(*bits)}


def make_step(mesh, edges, params, label_rows: np.ndarray,
              targets: np.ndarray,
              compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """One step of ``multihost_sim``'s loop without the optimizer, from the
    same parameters on every call: the node-sharded embedding -> halo conv
    -> ReLU -> halo conv -> BCE over the labelled rows; returns ``step()``
    -> (loss, the gradients of each shard's embedding and of every layer's
    parameters)."""
    emb_host, layers_host = params
    dev = mesh.first
    emb = node_rows_from_numpy(emb_host, mesh)
    layers = [RGCNLayer(*[torch.tensor(a, device=dev) for a in layer])
              for layer in layers_host]
    leaves = [*emb.parts, *(p for layer in layers for p in layer.parameters())]
    pick = row_pick(label_rows, emb.n_per, mesh.devices)
    y = torch.as_tensor(targets).to(dev)

    def step():
        z = halo_rgcn_conv(emb, edges, layers[0], mesh,
                           compute_dtype=compute_dtype).map(torch.relu)
        logits = halo_rgcn_conv(z, edges, layers[1], mesh,
                                compute_dtype=compute_dtype)
        loss = F.binary_cross_entropy_with_logits(
            pick.take(logits), y, reduction="sum") / pick.count
        return (loss.detach(), *torch.autograd.grad(loss, leaves))

    return step


def compare_step(step: Callable, devices: Sequence[torch.device],
                 exchange: str, steps: int = 5,
                 trace_dir: Optional[str] = None) -> Dict[str, Any]:
    """:func:`make_step`'s ``step`` with the ``exchange`` in both arms:
    whether the loss and every gradient have the same bits, whether two
    overlapped steps repeat their bits (``determinism_check``), ms per
    step of each arm (the median of ``steps`` synchronised steps, the arms
    in turns: overlapped, blocked, blocked, overlapped) and, with a
    ``trace_dir``, each arm's window over one traced step."""
    out: Dict[str, Any] = {"exchange": exchange, "ms_per_step": {}}
    with env_set(EXCHANGE_ENV, EXCHANGES[exchange]):
        bits, times = {}, {name: [] for name, _ in ARMS}
        for name, blocked in ARMS + ARMS[::-1]:
            with env_set(BLOCK_OVERLAP_ENV, "1" if blocked else None):
                bits.setdefault(name, step())
                for _ in range(steps):
                    sync(devices)
                    t0 = time.perf_counter()
                    step()
                    sync(devices)
                    times[name].append((time.perf_counter() - t0) * 1e3)
        out["same_bits"] = tracing.same_bits(bits["overlapped"],
                                             bits["blocked"])
        with env_set(BLOCK_OVERLAP_ENV, None):
            out["repeats_bits"] = tracing.determinism_check(step)
        out["loss"] = float(bits["overlapped"][0])
        out["ms_per_step"] = {k: float(np.median(v)) for k, v in times.items()}
        if trace_dir is not None:
            out["window"] = {}
            for name, blocked in ARMS:
                with env_set(BLOCK_OVERLAP_ENV, "1" if blocked else None):
                    out["window"][name] = _window(step, trace_dir)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cards", action="store_true",
                    help="one shard per visible card (default: OV_DEVICES "
                         "virtual shards of one device)")
    ap.add_argument("--trace", default=None,
                    help="where the traces go (default: a temporary "
                         "directory, removed after)")
    args = ap.parse_args(argv)
    mode = exchange_mode()
    if mode == "fused":
        raise SystemExit(f"{EXCHANGE_ENV}=fused: kernel #7 exchanges and "
                         "aggregates in one kernel and has no blocked arm; "
                         "measure the library exchange or #6")
    exchange = "kernel" if mode == "kernel" else "library"
    s = setup(knobs(), args.device, args.cards)
    with contextlib.ExitStack() as stack:
        trace_dir = args.trace
        if trace_dir is None and args.device == "cuda":
            trace_dir = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="measure_overlap_"))
        rec = measure(s, exchange, trace_dir)
    if args.device == "cuda":
        rec["card"] = card_name()
    print(json.dumps(rec), flush=True)
    if not rec["same_bits"]:
        print("measure_overlap: the arms' outputs or gradients differ",
              file=sys.stderr, flush=True)
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
