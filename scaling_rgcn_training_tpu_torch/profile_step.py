"""Where a train step's time goes on the card: ``torch.profiler`` over a
window of ``Trainer.fit`` steps at the bench shape of ``bench_shape.py``
(also ``chip_smoke.py``'s: N 200,000, E 4,000,000, 91 relation slots,
64 -> 16 -> 8, uniform random edges from seed 0), or with ``--shape am``
over a window of ``rehearse_am.py``'s steps at the AM shape (N 1,600,000,
E 12,000,000, 267 slots, 64 -> 16 -> 11, no validation forward; ``--conv``
``fused`` or ``edge``, the embedding model; ``AM_*`` knobs as there).

    python -m scaling_rgcn_training_tpu_torch.profile_step --conv edge
    python -m scaling_rgcn_training_tpu_torch.profile_step --shape am

``--conv``: ``fused`` (span kernels), ``edge`` (edges built without the span
plan, ``backend="pallas"``), ``attention`` (``aggr="attention"``,
``backend="pallas"``), ``halo`` (the halo partition over ``--shards``
virtual shards of the card, with the ``--exchange`` ``library``, ``kernel``
(#6) or ``fused`` (#7)) or ``edge-partition`` (the edge partition over
``--shards`` virtual shards, ``backend="pallas"``). ``--head``: the model,
``summation`` (the embedding model) or the ``mlp`` or ``attention`` head
over 4 transferred embeddings, frozen (``bench_shape.bench_trainer``).
Prints the card, the route of the step (``train/step_graph.py``: a
captured CUDA graph replayed, or eagerly with ``RGCN_EAGER_STEP=1``), wall
ms/step over the window, the device's busy ms/step (the sum of kernel
times, and the union of their intervals: a replayed graph runs
independent kernels side by side), its idle share (from the union), and
the kernels by device time per step. ``--shapes OPS`` also splits the operators whose
names hold one of the comma-separated ``OPS`` (``index_select``: the row
gathers) by their input shapes (``record_shapes``), with each group's
device time and calls per step: a gather of ``[E, h]`` rows is a
permutation of the edge stream, one of ``[N, h]`` rows a node table's.
``--trace DIR`` also writes a Chrome trace into ``DIR`` (``utils/tracing.py``
``trace``; the timed window is the region ``bench_train_step``, the name
the JAX package's ``scripts/trace_step.py`` gives its traced step); with
``--conv halo`` and the library exchange or #6 it also counts, by
timestamps (``tracing.kernels_inside``), the compute kernels (#1, #2, #3)
that run inside the exchange kernels' windows (#6: ``halo_pull_kernel``;
the library exchange: its ``torch.stack`` copies, ``CatArrayBatchedCopy``,
with the layer output's one ``torch.cat`` among them). Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from scaling_rgcn_training_tpu_torch import rehearse_am as ra
from scaling_rgcn_training_tpu_torch.train.step_graph import (
    describe, step_route)
from scaling_rgcn_training_tpu_torch.utils import tracing


def _device_time(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def _device_time_total(evt) -> float:
    """An operator's device time with the kernels it launched."""
    t = getattr(evt, "device_time_total", None)
    return float(t if t is not None else evt.cuda_time_total)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=["bench", "am"], default="bench")
    ap.add_argument("--conv", choices=["fused", "edge", "attention", "halo",
                                       "edge-partition"], default="fused")
    ap.add_argument("--exchange", choices=["library", "kernel", "fused"],
                    default="library", help="the halo exchange (--conv halo)")
    ap.add_argument("--shards", type=int, default=4,
                    help="virtual shards of the card (halo, edge-partition)")
    ap.add_argument("--head", choices=["summation", "mlp", "attention"],
                    default="summation")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--warmup", type=int, default=5, help="steps before the "
                    "window (at least 2)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace", type=str, default=None,
                    help="a directory for the Chrome trace")
    ap.add_argument("--shapes", type=str, default=None,
                    help="comma-separated operator names to split by input "
                    "shape, e.g. index_select")
    args = ap.parse_args(argv)
    if args.shape == "am" and (args.conv not in ("fused", "edge")
                               or args.head != "summation"):
        ap.error("--shape am takes --conv fused or edge and the summation "
                 "head")
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    print(ra.card_name(), flush=True)
    compute_dtype = None if args.dtype == "float32" else args.dtype
    if args.shape == "am":
        k = dict(ra.knobs(), inner=args.warmup + args.steps, calls=0)
        edges, rows, targets, slots, _ = ra.build_edges(k, "cuda")

        def run(on_step):
            ra.run(k, torch.device("cuda"), edges, rows, targets, slots,
                   None if compute_dtype is None
                   else getattr(torch, compute_dtype), args.conv,
                   on_step=on_step)
    else:
        run = _bench_run(args, compute_dtype)
    stamps = []
    window = tracing.annotate("bench_train_step")

    def on_epoch(epoch):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        # the timed window, a named region of the trace
        if len(stamps) == args.warmup + args.steps:
            window.__exit__(None, None, None)
        prof.step()
        if len(stamps) == args.warmup:
            window.__enter__()

    with tracing.trace(args.trace, schedule=torch.profiler.schedule(
            wait=args.warmup - 1, warmup=1, active=args.steps, repeat=1),
            record_shapes=args.shapes is not None) as prof:
        run(on_epoch)
    wall = (stamps[-1] - stamps[args.warmup - 1]) * 1e3 / args.steps
    # device events, without the annotated ranges laid over the kernels
    # (the profiler's per-step ones, and the optimizer's: counted, the
    # Adam step's kernels were summed twice into busy)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("ProfilerStep", "Optimizer.step#"))]
    busy = sum(_device_time(e) for e in kernels) / 1e3 / args.steps
    union = _busy_union(prof) / 1e3 / args.steps
    name = f"{args.conv} {args.exchange}" if args.conv == "halo" else args.conv
    name += " (AM shape)" if args.shape == "am" else ""
    name += "" if args.head == "summation" else f" {args.head} head"
    print(f"{name} {args.dtype} [step {describe(step_route(['cuda']))}]: "
          f"wall {wall:.3f} ms/step, device busy {busy:.3f} ms/step "
          f"(union {union:.3f}), idle share {1 - union / wall:.3f} "
          f"({args.steps} steps after {args.warmup})", flush=True)
    for e in sorted(kernels, key=_device_time, reverse=True)[:args.top]:
        print(f"  {_device_time(e) / 1e3 / args.steps:8.3f} ms/step "
              f"{e.count / args.steps:6.1f}/step  {e.key[:150]}", flush=True)
    if args.shapes:
        _print_by_shape(prof, args.shapes.split(","), args.steps)
    if args.trace:
        print(f"trace written: {prof.trace_path}", flush=True)
        if args.conv == "halo" and args.exchange != "fused":
            exchange = ("halo_pull_kernel",) if args.exchange == "kernel" \
                else ("CatArrayBatchedCopy",)
            got = tracing.kernels_inside(
                tracing.gpu_events(prof.trace_path),
                lambda n: n.split("::")[-1].startswith(exchange),
                lambda n: n.startswith(("span_", "segment_sum")))
            print(f"exchange windows ({exchange[0]}): {got['inside']} "
                  f"compute kernels inside over {args.steps} steps "
                  f"({got['kernels']}), window {got['window_ms']:.3f} ms, "
                  f"overlap {got['overlap_ms']:.3f} ms, busy (union) "
                  f"{got['busy_ms']:.3f} ms, {got['streams']} streams",
                  flush=True)


def _busy_union(prof) -> float:
    """The union of the device events' intervals in the profile, in
    microseconds (the annotated ranges left out)."""
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and not e.name.startswith(("ProfilerStep", "Optimizer.step#"))]
    return sum(hi - lo for lo, hi in tracing._union(spans))


def _bench_run(args, compute_dtype):
    """``run(on_epoch)``: ``Trainer.fit`` of ``args``' model and conv at
    the bench shape, ``on_epoch`` after each step."""
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss

    kw = {} if args.conv in ("fused", "halo") else {"backend": "pallas"}
    if args.conv in ("halo", "edge-partition"):
        from scaling_rgcn_training_tpu_torch.parallel import halo, spmd
        from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=("cuda",) * args.shards)
        kw.update(mesh=mesh, partition=args.conv.split("-")[0])
        if args.conv == "halo":
            edges = halo.device_put_halo_edges(halo.halo_partition_edges(
                *bs.bench_edges(), bs.N, bs.SLOTS, args.shards), mesh)
            os.environ.pop(halo.EXCHANGE_ENV, None)
            if args.exchange != "library":
                os.environ[halo.EXCHANGE_ENV] = \
                    "fused" if args.exchange == "fused" else "1"
        else:
            edges = spmd.device_put_sharded_edges(spmd.shard_rel_edges(
                *bs.bench_edges(), bs.N, bs.SLOTS, args.shards), mesh)
    else:
        edges = build_rel_edges(*bs.bench_edges(), bs.N, bs.SLOTS,
                                device="cuda", span=args.conv == "fused")
    graph = DeviceGraph(edges=edges, **bs.bench_splits("cuda"))
    if args.conv == "attention":
        kw["aggr"] = "attention"
    trainer, model = bs.bench_trainer(
        args.warmup + args.steps, "cuda",
        compute_dtype=compute_dtype,
        head=args.head, **kw)

    def run(on_epoch):
        trainer.fit(model, graph, bce_loss, "sigmoid", sum_graph=False,
                    frozen=() if args.head == "summation" else ("embedding",),
                    verbose=False, on_epoch=on_epoch)
    return run


def _print_by_shape(prof, ops, steps: int) -> None:
    """Device ms and calls per step of each operator named in ``ops``,
    one line per distinct list of input shapes, largest first, then each
    operator's total."""
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.device_type == torch.autograd.DeviceType.CPU
            and any(op in e.key for op in ops)]
    ms = lambda e: _device_time_total(e) / 1e3 / steps
    totals = {}
    for e in sorted(rows, key=ms, reverse=True):
        t = totals.setdefault(e.key, [0.0, 0.0])
        t[0] += ms(e)
        t[1] += e.count / steps
        print(f"  {ms(e):8.3f} ms/step {e.count / steps:6.1f}/step  {e.key} "
              f"{e.input_shapes}", flush=True)
    for key, (t_ms, calls) in totals.items():
        print(f"  {t_ms:8.3f} ms/step {calls:6.1f}/step  {key} (all shapes)",
              flush=True)


if __name__ == "__main__":
    main()
