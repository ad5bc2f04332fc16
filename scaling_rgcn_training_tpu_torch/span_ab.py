"""#1, #2 and #7 of two trees of the port on one card, in turns: whether a
change to the tensor-core kernels' shared code (``csrc/span_tc.cuh``)
moved their times or their bits.

    python -m scaling_rgcn_training_tpu_torch.span_ab --other DIR

``DIR`` is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Four processes run one after another, in the order
other, this, this, other; each builds its own tree's kernels into that
tree's ``build/``, builds the bench shape's span plan and its halo
partition over 4 virtual shards of the card (``bench_shape.py``) and times
``span_forward`` (#1), ``span_backward`` (#2) and ``fused_halo_aggregate``
(#7, one layer forward over the 4 shards) at layers 1 and 2 in float32 and
bfloat16 with CUDA events (the mean of ``--reps`` calls after one), with a
digest of each output's bits (the same inputs in both trees, from one
numpy seed) and ptxas's registers of each kernel it built, printing one
JSON line; the last line holds all four, whether both trees gave the same
bits, and the card's name and power limit. Only the functions both trees
have are called. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# virtual shards of the card for #7 (chip_smoke.py phase 8's)
HALO_SHARDS = 4


def time_tree(reps: int) -> dict:
    """The times of #1 and #2 of the package on ``sys.path``."""
    import numpy as np
    import torch

    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
    from scaling_rgcn_training_tpu_torch.parallel import fused_halo as fh
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        device_put_halo_edges, halo_partition_edges)
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    src, dst, typ = bs.bench_edges()
    plan = build_rel_edges(src, dst, typ, bs.N, bs.SLOTS, device="cuda").span
    he = device_put_halo_edges(
        halo_partition_edges(src, dst, typ, bs.N, bs.SLOTS, HALO_SHARDS),
        make_mesh(devices=("cuda",) * HALO_SHARDS))
    rng = np.random.default_rng(0)
    t = lambda shape, dtype, s=1.0: torch.as_tensor(
        rng.standard_normal(shape) * s, dtype=torch.float32).to("cuda", dtype)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def ms(fn) -> float:
        fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    res, bits = {}, {}
    for layer, d_in, d_out in (("L1", bs.D, bs.HL), ("L2", bs.HL, bs.C)):
        for dtype in (torch.float32, torch.bfloat16):
            x = t((bs.N, d_in), dtype)
            w = t((bs.SLOTS, d_in, d_out), dtype, 0.2)
            g = t((bs.N, d_out), dtype)
            xh = t((HALO_SHARDS * he.n_per, d_in), dtype).split(he.n_per)
            tag = f"{layer} {str(dtype)[6:]}"
            calls = {
                "span_forward": lambda: [sk.span_forward(x, w, plan)],
                "span_backward": lambda: list(sk.span_backward(g, x, w, plan)),
                "fused_halo_aggregate": lambda: [
                    out for sh in he.shards
                    for out in fh.fused_halo_aggregate(list(xh), w, sh.fused)]}
            for name, call in calls.items():
                res[f"{name} {tag}"] = ms(call)
                bits[f"{name} {tag}"] = digest(call())
    res["bits"] = bits
    res["registers"] = registers()
    return res


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (16 hex digits)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def registers() -> dict:
    """ptxas's registers of each kernel this process built, by its mangled
    name."""
    import re

    from scaling_rgcn_training_tpu_torch.ops import cuda_build

    out = {}
    for log in cuda_build.build_logs.values():
        name = None
        for line in log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name] = int(m.group(1))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--time", action="store_true",
                    help="time the package on sys.path in this process")
    args = ap.parse_args(argv)
    if args.time:
        out = time_tree(args.reps)
        print(json.dumps(out), flush=True)
        return out
    if not args.other:
        ap.error("--other is required")
    other = os.path.abspath(args.other)
    runs = []
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time", "--reps",
             str(args.reps)], cwd=root, env=env, capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{name} ({root}) exited {proc.returncode}")
        runs.append({"tree": name, **json.loads(proc.stdout.splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"card": card, "order": [r["tree"] for r in runs],
               "same_bits": all(r["bits"] == runs[0]["bits"] for r in runs),
               "runs": runs}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
