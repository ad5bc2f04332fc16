"""Attribution microbench of the span conv's backward: where its time goes.

    python -m scaling_rgcn_training_tpu_torch.bwd_variants [--d-in 64]
        [--d-out 16] [--inner 10] [--only base,nodw] [--dtype float32]
        [--device cuda]

Counterpart of the JAX package's ``scripts/bwd_variants.py`` (its
``V_IN``, ``V_OUT``, ``V_INNER`` and ``V_ONLY`` are the flags ``--d-in``,
``--d-out``, ``--inner`` and ``--only``), over the bench shape of
``bench_shape.py`` (N 200,000, E 4,000,000, 91 relation slots, uniform
random edges from seed 0, mean norms); layer 1 is 64 -> 16 (the default),
layer 2 16 -> 8. Rows, each the TPU variant of the same name where
there is one:

- ``base``: kernel #8's redesign (``ops/bwd_kernels.py``
  ``span_backward_variant``, ``bwd_tc_kernel`` on the tensor cores over
  the bucket plan, ``--bucket-rows`` src rows a bucket), dx and dW in one
  pass;
- ``nodw``: the redesign, dx only; ``nodx``: dW only; ``tf32``: one TF32
  product per multiply-add instead of the float32 split (wrong bits: the
  cost of the split; bfloat16 runs ``base``);
- ``noonehot``: the redesign's ``base`` over the plan with ``dst`` folded
  into a 4,096-row window that stays in L2 (the cost of the random
  ``g_out`` gather; the TPU variant dropped the one-hot matrix that is its
  gather);
- ``simt``: #8's earlier route on the CUDA cores
  (``span_backward_variant_simt``, dW by shared-memory atomics), dx and dW;
  ``statrmw``: the earlier route with every edge's dW added into its
  relation pass's first slot (wrong math: the cost of indexing dW per
  relation);
- ``fwdrev``: the ``span_rows`` kernel (``span_forward_rows``) over the
  backward plan with ``W^T`` (the dx half of #2's earlier route alone);
- ``shipped``: ``span_backward`` (#2: dx messages and dW partials on the
  tensor cores per relation chunk, then their sums); ``rows``:
  ``span_backward_rows`` (#2's earlier route on the CUDA cores);
  ``fwdnorm``: ``span_forward`` (#1, its tensor-core messages and their CSR
  sum) on the forward plan;
- ``floor``: the harness alone, one empty launch per call.

Each row but ``floor`` is first held against its plain PyTorch version on
the same inputs (float32 within 1e-4 * |ref| + 1e-4 * max|ref|, bfloat16
within 2e-2 * max|ref|; a mismatch exits non-zero), then timed with CUDA
events over ``--inner`` calls, best of 3. Printed per row: ms, the bound
(the larger of the bytes each input read once and each output written once
over 3.35 TB/s and the operations over the peak of the units that run
them, an H100 SXM's: 67 TFLOP/s float32 on the CUDA cores (``simt``,
``statrmw``, ``fwdrev``, ``rows``), 495 TFLOP/s TF32 (the redesign's rows,
``shipped`` and ``fwdnorm`` in float32: ``span_kernels.backward_cost`` and
``forward_cost``, three TF32 products per multiply-add, one for ``tf32``;
``nodw`` and ``nodx`` one half of it) and 989 bfloat16 on the tensor
cores), the largest difference from the plain version, and for ``base``
and ``shipped`` the peak device memory one call adds
(``torch.cuda.max_memory_allocated``) and the row's ms split over the
kernels a call launches by their shares of its device time
(``torch.profiler``); with ``--phases``, under each row
of the redesign the cycles a stage of each phase of its kernel (warp 0's
``clock64`` in a build with ``-DBWD_TC_PHASES``,
``ops/bwd_kernels.py`` ``tc_phases``); a JSON line last. ``--device cpu``
runs the plain versions and measures no time.

Not carried over from the TPU script: ``hint``; ``mxurep``, ``mxuall``;
``minimal``, ``minimal16``, ``minsplit``; ``overwrite``, ``mintrans``;
``nomexp``, ``norel``; ``wide``. Each measures a Mosaic alignment hint, an
MXU one-hot or lane-repeat layout, or a TPU tile width; none has a
counterpart in a CUDA row kernel.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, List, Optional

import torch

ROWS = ("base", "nodw", "nodx", "tf32", "noonehot", "simt", "statrmw",
        "fwdrev", "shipped", "rows", "fwdnorm", "floor")
# rows of the redesign, and of the earlier route
TC_ROWS = ("base", "nodw", "nodx", "tf32", "noonehot")
# H100 SXM: HBM bytes/s; peak operations/s of the units (CUDA-core f32,
# dense TF32 and bf16 tensor cores)
HBM_RATE = 3.35e12
PEAK_RATE = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
WINDOW = 4096


def bound(n_bytes: float, ops: float, unit: str) -> dict:
    t_bytes, t_ops = n_bytes / HBM_RATE, ops / PEAK_RATE[unit]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_error(got, ref, dtype: torch.dtype) -> Optional[float]:
    """Largest ``|got - ref|`` over the outputs, or None when one is
    outside the tolerance."""
    err = 0.0
    for a, b in zip(got, ref):
        if a is None:
            continue
        a, b = a.float(), b.float()
        scale = float(b.abs().max()) if b.numel() else 0.0
        diff = (a - b).abs()
        limit = 2e-2 * scale if dtype == torch.bfloat16 else \
            1e-4 * scale + 1e-4 * b.abs()
        if not bool(torch.isfinite(a).all()) or not bool((diff <= limit).all()):
            return None
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


def time_ms(fn, inner: int) -> float:
    """Best of 3 CUDA-event times of ``inner`` calls, per call."""
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def row_specs(plan, g, x, w, names, bucket_rows: int):
    """``(specs, phases)``: ``specs`` maps a row's name to ``(kernel call,
    plain call, bytes, operations, unit)``, the calls returning tuples of
    outputs, bytes and operations those of the row's function on these
    inputs, the operations at the peak of ``unit`` (``PEAK_RATE``: the
    input type's, or ``tf32``); ``phases`` maps each of the redesign's rows
    to a call of ``bwd_kernels.tc_phases`` on its inputs."""
    from scaling_rgcn_training_tpu_torch.ops import bwd_kernels as bk
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk

    (n, d_out), (n_src, d_in), slots = g.shape, x.shape, w.shape[0]
    e = plan.bwd_dst.numel()
    csr = nbytes(plan.bwd_rowptr, plan.bwd_dst, plan.bwd_rel, plan.bwd_norm)
    gb, xb, wb = nbytes(g), nbytes(x), nbytes(w)
    dxb, dwb = 4 * n_src * d_in, 4 * slots * d_in * d_out
    half = 2 * e * d_in * d_out
    unit = str(x.dtype)[6:]
    specs, phases = {}, {}

    def tc(p, v, name=None):
        phases[name or v] = lambda: bk.tc_phases(g, x, w, p, v)
        return (lambda: bk.span_backward_variant(g, x, w, p, v),
                lambda: bk.span_backward_variant_plain(g, x, w, p, v))

    if set(names) & {"base", "nodw", "nodx", "tf32"}:
        buckets = bk.plan_buckets(plan, bucket_rows)
        n_bytes, ops, tc_unit = sk.backward_cost(g, x, w, plan)
        specs["base"] = tc(buckets, "base") + (n_bytes, ops, tc_unit)
        specs["nodw"] = tc(buckets, "nodw") + (n_bytes - xb - dwb, ops // 2,
                                               tc_unit)
        specs["nodx"] = tc(buckets, "nodx") + (n_bytes - dxb, ops // 2,
                                               tc_unit)
        specs["tf32"] = tc(buckets, "tf32") + (
            (n_bytes, ops // 3, "tf32") if x.dtype == torch.float32
            else (n_bytes, ops, tc_unit))
    if "noonehot" in names:
        folded = bk.fold_dst(plan, WINDOW)
        n_bytes, ops, tc_unit = sk.backward_cost(g, x, w, folded)
        specs["noonehot"] = tc(bk.plan_buckets(folded, bucket_rows), "base",
                               "noonehot") + (
            n_bytes - gb * (1 - min(n, WINDOW) / max(n, 1)), ops, tc_unit)

    def simt(v):
        return (lambda: bk.span_backward_variant_simt(g, x, w, plan, v),
                lambda: bk.span_backward_variant_simt_plain(g, x, w, plan, v),
                gb + xb + wb + csr + dxb + dwb, 2 * half, unit)

    specs["simt"], specs["statrmw"] = simt("base"), simt("statrmw")
    rev, wt = bk.reverse_plan(plan), w.transpose(1, 2).contiguous()
    specs["fwdrev"] = (lambda: (sk.span_forward_rows(g, wt, rev),),
                       lambda: (sk.span_forward_plain(g, wt, rev),),
                       gb + wb + csr + dxb, half, unit)
    specs["shipped"] = (lambda: sk.span_backward(g, x, w, plan),
                        lambda: sk.span_backward_plain(g, x, w, plan),
                        *sk.backward_cost(g, x, w, plan))
    specs["rows"] = (lambda: sk.span_backward_rows(g, x, w, plan),
                     specs["shipped"][1], *specs["simt"][2:])
    specs["fwdnorm"] = (lambda: (sk.span_forward(x, w, plan),),
                        lambda: (sk.span_forward_plain(x, w, plan),),
                        *sk.forward_cost(x, w, plan))
    specs["floor"] = ((lambda: bk.floor_launch(g.device)) if g.is_cuda
                      else (lambda: None), None, 0, 0, unit)
    return {k: specs[k] for k in names}, phases


def kernel_shares(fn, calls: int = 5) -> Dict[str, float]:
    """Each CUDA kernel's share of the device time ``fn``'s calls spend in
    the kernels they launch, by kernel name (``torch.profiler`` over
    ``calls`` calls after one). Shares, not times: a profile may keep
    fewer calls' events than it ran."""
    from scaling_rgcn_training_tpu_torch.profile_step import _device_time

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + _device_time(e)
    total = sum(out.values()) or 1.0
    return {k: v / total for k, v in out.items()}


def peak_mib(fn) -> float:
    """Device memory one call of ``fn`` adds at its peak, MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak / 2**20


def run_rows(plan, d_in: int, d_out: int, dtype: torch.dtype, inner: int,
             names=ROWS, seed: int = 0, bucket_rows: Optional[int] = None,
             phases: bool = False) -> Dict[str, dict]:
    """Every named row on ``plan``'s device: its check against the plain
    version, its time (None on the CPU) and its bound, and with
    ``phases`` (on the card) the redesign's rows' cycles a stage in each
    phase of its kernel; printed and returned. Raises SystemExit when a row
    disagrees."""
    dev = plan.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(plan.num_nodes, d_out, generator=gen, device=dev).to(dtype)
    x = torch.randn(plan.num_src, d_in, generator=gen, device=dev).to(dtype)
    w = (torch.randn(plan.num_slots, d_in, d_out, generator=gen, device=dev)
         * 0.2).to(dtype)
    on_card = dev.type == "cuda"
    results, bad = {}, []
    from scaling_rgcn_training_tpu_torch.ops.bwd_kernels import BUCKET_ROWS

    specs, phase_calls = row_specs(plan, g, x, w, names,
                                   bucket_rows or BUCKET_ROWS)
    for name, (kernel, plain, n_bytes, ops, unit) in specs.items():
        err = None
        if plain is not None:
            err = max_error(kernel(), plain(), dtype)
            if err is None:
                bad.append(name)
        ms = time_ms(kernel, inner) if on_card else None
        res = {"ms": ms, **bound(n_bytes, ops, unit), "max_abs_err": err}
        if on_card and name in ("base", "shipped"):
            res["peak_mib"] = peak_mib(kernel)
            res["kernels_ms"] = {k: v * ms for k, v in
                                 kernel_shares(kernel).items()}
        results[name] = res
        shown = "not measured" if ms is None else f"{ms:9.4f} ms"
        check = "" if plain is None else \
            "  MISMATCH" if err is None else f"  max_abs_err {err:.3e}"
        peak = f"  peak +{res['peak_mib']:.1f} MiB" if "peak_mib" in res else ""
        print(f"{name:10s} {shown}  bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}){check}{peak}", flush=True)
        if "kernels_ms" in res:
            print("    kernels (their shares of the row's ms): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in res["kernels_ms"].items()),
                flush=True)
        if phases and on_card and name in phase_calls:
            res["phases"] = ph = phase_calls[name]()
            print(f"    {ph['stages']:.0f} stages and {ph['bucket_passes']:.0f}"
                  f" bucket passes a block, {ph['cycles']:.4g} cycles; "
                  "cycles a stage, warp 0:", flush=True)
            for phase, c in ph["cycles_per_stage"].items():
                print(f"      {phase:24s} {c:8.0f}", flush=True)
    if bad:
        raise SystemExit(f"bwd_variants: {bad} disagree with their plain "
                         "versions")
    return results


def build_plan(nodes: int, edges: int, slots: int, device):
    """The bench graph's span plan (mean norms) on ``device``."""
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges

    src, dst, typ = bs.bench_edges(0, nodes, edges, slots)
    return build_rel_edges(src, dst, typ, nodes, slots, device=device).span


def main(argv: Optional[List[str]] = None) -> dict:
    from scaling_rgcn_training_tpu_torch import bench_shape as bs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-in", type=int, default=bs.D)
    ap.add_argument("--d-out", type=int, default=bs.HL)
    ap.add_argument("--inner", type=int, default=10,
                    help="calls per timed batch")
    ap.add_argument("--only", type=str, default="",
                    help=f"comma-separated rows of {','.join(ROWS)}")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--nodes", type=int, default=bs.N)
    ap.add_argument("--edges", type=int, default=bs.E)
    ap.add_argument("--slots", type=int, default=bs.SLOTS)
    ap.add_argument("--phases", action="store_true",
                    help="also time the phases of the redesign's kernel "
                    "(its -DBWD_TC_PHASES build; on the card)")
    ap.add_argument("--bucket-rows", type=int, default=None,
                    help="src rows a bucket of the redesign's plan "
                    "(default ops/bwd_kernels.py BUCKET_ROWS)")
    args = ap.parse_args(argv)
    names = [v for v in args.only.split(",") if v] or list(ROWS)
    unknown = set(names) - set(ROWS)
    if unknown:
        raise SystemExit(f"unknown rows {sorted(unknown)}; rows are {ROWS}")
    device = torch.device(args.device)
    card = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bwd_variants: no CUDA device (pass --device "
                             "cpu to run the plain versions)")
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
    dtype = getattr(torch, args.dtype)
    plan = build_plan(args.nodes, args.edges, args.slots, device)
    print(f"N={args.nodes} E={args.edges} slots={args.slots} "
          f"d_in={args.d_in} d_out={args.d_out} {args.dtype} "
          f"inner={args.inner} on {device}"
          + ("" if card else " (times not measured)"), flush=True)
    from scaling_rgcn_training_tpu_torch.ops.bwd_kernels import BUCKET_ROWS

    bucket_rows = args.bucket_rows or BUCKET_ROWS
    rows = run_rows(plan, args.d_in, args.d_out, dtype, args.inner, names,
                    bucket_rows=bucket_rows, phases=args.phases)
    out = {"card": card, "device": str(device),
           "shape": {"nodes": args.nodes, "edges": args.edges,
                     "slots": args.slots, "d_in": args.d_in,
                     "d_out": args.d_out, "dtype": args.dtype,
                     "bucket_rows": bucket_rows},
           "inner": args.inner, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
