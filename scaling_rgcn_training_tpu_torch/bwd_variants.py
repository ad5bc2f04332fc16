"""Attribution microbench of the span conv's backward: where its time goes.

    python -m scaling_rgcn_training_tpu_torch.bwd_variants [--d-in 64]
        [--d-out 16] [--inner 10] [--only base,nodw] [--dtype float32]
        [--device cuda]

Counterpart of the JAX package's ``scripts/bwd_variants.py`` (its
``V_IN``, ``V_OUT``, ``V_INNER`` and ``V_ONLY`` are the flags ``--d-in``,
``--d-out``, ``--inner`` and ``--only``), over the bench shape of
``bench_shape.py`` (N 200,000, E 4,000,000, 91 relation slots, uniform
random edges from seed 0, mean norms); layer 1 is 64 -> 16 (the default),
layer 2 16 -> 8. Rows, each the TPU variant of the same name:

- ``base``: kernel #8 (``ops/bwd_kernels.py``), dx and dW in one pass;
- ``nodw``: #8, dx only; ``nodx``: #8, dW only;
- ``statrmw``: #8 with every edge's dW added into its relation pass's
  first slot (wrong math: the cost of indexing dW per relation);
- ``noonehot``: #8 over the plan with ``dst`` folded into a 4,096-row
  window that stays in L2 (the cost of the random ``g_out`` gather; the
  TPU variant dropped the one-hot matrix that is its gather);
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
them, 67 TFLOP/s float32 on the CUDA cores, 495 TFLOP/s TF32 (``shipped``
and ``fwdnorm`` in float32: ``span_kernels.backward_cost`` and
``forward_cost``, three TF32 products per multiply-add) and 989 bfloat16
on the tensor cores: an H100 SXM) and the
largest difference
from the plain version; a JSON line last. ``--device cpu`` runs the plain
versions and measures no time.

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

ROWS = ("base", "nodw", "nodx", "statrmw", "noonehot", "fwdrev", "shipped",
        "rows", "fwdnorm", "floor")
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


def row_specs(plan, g, x, w, names) -> Dict[str, tuple]:
    """``name -> (kernel call, plain call, bytes, operations, unit)``: the
    calls return tuples of outputs; bytes and operations are those of the
    row's function on these inputs, the operations at the peak of
    ``unit`` (``PEAK_RATE``: the input type's, or ``tf32``)."""
    from scaling_rgcn_training_tpu_torch.ops import bwd_kernels as bk
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk

    (n, d_out), (n_src, d_in), slots = g.shape, x.shape, w.shape[0]
    e = plan.bwd_dst.numel()
    csr = nbytes(plan.bwd_rowptr, plan.bwd_dst, plan.bwd_rel, plan.bwd_norm)
    gb, xb, wb = nbytes(g), nbytes(x), nbytes(w)
    dxb, dwb = 4 * n_src * d_in, 4 * slots * d_in * d_out
    half = 2 * e * d_in * d_out
    unit = str(x.dtype)[6:]
    specs = {}

    def calls(p, v):
        return (lambda: bk.span_backward_variant(g, x, w, p, v),
                lambda: bk.span_backward_variant_plain(g, x, w, p, v))

    for v in bk.VARIANTS:
        specs[v] = calls(plan, v)
    specs["base"] += (gb + xb + wb + csr + dxb + dwb, 2 * half, unit)
    specs["statrmw"] += specs["base"][2:]
    specs["nodw"] += (gb + wb + csr + dxb, half, unit)
    specs["nodx"] += (gb + xb + csr + dwb, half, unit)
    if "noonehot" in names:
        folded = bk.fold_dst(plan, WINDOW)
        specs["noonehot"] = calls(folded, "base") + (
            gb * min(n, WINDOW) / max(n, 1) + xb + wb + csr + dxb + dwb,
            2 * half, unit)
    rev, wt = bk.reverse_plan(plan), w.transpose(1, 2).contiguous()
    specs["fwdrev"] = (lambda: (sk.span_forward_rows(g, wt, rev),),
                       lambda: (sk.span_forward_plain(g, wt, rev),),
                       gb + wb + csr + dxb, half, unit)
    specs["shipped"] = (lambda: sk.span_backward(g, x, w, plan),
                        lambda: sk.span_backward_plain(g, x, w, plan),
                        *sk.backward_cost(g, x, w, plan))
    specs["rows"] = (lambda: sk.span_backward_rows(g, x, w, plan),
                     specs["shipped"][1], *specs["base"][2:])
    specs["fwdnorm"] = (lambda: (sk.span_forward(x, w, plan),),
                        lambda: (sk.span_forward_plain(x, w, plan),),
                        *sk.forward_cost(x, w, plan))
    specs["floor"] = ((lambda: bk.floor_launch(g.device)) if g.is_cuda
                      else (lambda: None), None, 0, 0, unit)
    return {k: specs[k] for k in names}


def run_rows(plan, d_in: int, d_out: int, dtype: torch.dtype, inner: int,
             names=ROWS, seed: int = 0) -> Dict[str, dict]:
    """Every named row on ``plan``'s device: its check against the plain
    version, its time (None on the CPU) and its bound; printed and
    returned. Raises SystemExit when a row disagrees."""
    dev = plan.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(plan.num_nodes, d_out, generator=gen, device=dev).to(dtype)
    x = torch.randn(plan.num_src, d_in, generator=gen, device=dev).to(dtype)
    w = (torch.randn(plan.num_slots, d_in, d_out, generator=gen, device=dev)
         * 0.2).to(dtype)
    on_card = dev.type == "cuda"
    results, bad = {}, []
    for name, (kernel, plain, n_bytes, ops, unit) in row_specs(
            plan, g, x, w, names).items():
        err = None
        if plain is not None:
            err = max_error(kernel(), plain(), dtype)
            if err is None:
                bad.append(name)
        ms = time_ms(kernel, inner) if on_card else None
        res = {"ms": ms, **bound(n_bytes, ops, unit), "max_abs_err": err}
        results[name] = res
        shown = "not measured" if ms is None else f"{ms:9.4f} ms"
        check = "" if plain is None else \
            "  MISMATCH" if err is None else f"  max_abs_err {err:.3e}"
        print(f"{name:10s} {shown}  bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}){check}", flush=True)
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
    rows = run_rows(plan, args.d_in, args.d_out, dtype, args.inner, names)
    out = {"card": card, "device": str(device),
           "shape": {"nodes": args.nodes, "edges": args.edges,
                     "slots": args.slots, "d_in": args.d_in,
                     "d_out": args.d_out, "dtype": args.dtype},
           "inner": args.inner, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
