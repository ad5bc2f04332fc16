"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN;
2. build the span kernels from ``scaling_rgcn_training_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, for
   ``out``, ``dx`` and ``dW``: at a small edge-case shape (d_in 63, d_out 4
   and 11, empty relations, nodes with no edges) and at the bench shape
   (N 200,000, E 4,000,000, 91 relation slots, d 64 -> hidden 16 -> C 8);
   plus wide rows over 30 relations (several relation passes);
   float32 within rtol 1e-4 and atol 1e-4 * max|ref| (summation order
   differs), bfloat16 inputs within 2e-2 * max|ref|; kernel and plain
   times at the bench shape; then the conv's autograd on the card against
   the same conv on the CPU;
4. ``Trainer.fit`` of the baseline embedding model at the bench shape,
   10 epochs in float32 and 10 with bfloat16 edge streams: finite losses,
   the kernels' launch counters advanced on every step, ms/step;
5. the CLI on the GPU (summary pre-training, transfer, fine-tuning) on a
   synthetic dataset; the results JSON must exist.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "scaling_rgcn_training_tpu_torch"

# bench shape (bench.py: N, E, R, d, hl, C)
N, E, R, D, HL, C = 200_000, 4_000_000, 45, 64, 16, 8
SLOTS = 2 * R + 1
EPOCHS = 10
WARMUP = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check_close(name: str, got, ref, bf16: bool) -> float:
    """f32: |got - ref| <= 1e-4 * max|ref| + 1e-4 * |ref|;
    bf16 inputs: |got - ref| <= 2e-2 * max|ref|."""
    import torch

    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    diff = (got - ref).abs()
    if bf16:
        ok = bool((diff <= 2e-2 * scale).all())
    else:
        ok = bool((diff <= 1e-4 * scale + 1e-4 * ref.abs()).all())
    err = float(diff.max()) if diff.numel() else 0.0
    print(f"  {name}: max_abs_err {err:.3e} (max|ref| {scale:.3e}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_graph(rng, n, e, slots, n_live=None, live_rels=None):
    n_live = n if n_live is None else n_live
    src = rng.integers(0, n_live, e).astype(np.int32)
    dst = rng.integers(0, n_live, e).astype(np.int32)
    rels = np.arange(slots) if live_rels is None else np.asarray(live_rels)
    typ = rels[rng.integers(0, len(rels), e)].astype(np.int32)
    return src, dst, typ


def compare_kernels(sk, plan, d_in, d_out, dtype, rng, tag, timing=False):
    """span_forward / span_backward against their plain versions."""
    import torch

    dev = plan.device
    bf16 = dtype == torch.bfloat16
    x = torch.as_tensor(rng.standard_normal((plan.num_nodes, d_in)),
                        dtype=torch.float32).to(dev, dtype)
    w = torch.as_tensor(rng.standard_normal((plan.num_slots, d_in, d_out)) * 0.2,
                        dtype=torch.float32).to(dev, dtype)
    g = torch.as_tensor(rng.standard_normal((plan.num_nodes, d_out)),
                        dtype=torch.float32).to(dev, dtype)
    out = sk.span_forward(x, w, plan)
    torch.cuda.synchronize()
    out_ref = sk.span_forward_plain(x, w, plan)
    dx, dw = sk.span_backward(g, x, w, plan)
    torch.cuda.synchronize()
    dx_ref, dw_ref = sk.span_backward_plain(g, x, w, plan)
    torch.cuda.synchronize()
    res = {
        "fwd_err": check_close(f"{tag} out", out, out_ref, bf16),
        "bwd_err": max(check_close(f"{tag} dx", dx, dx_ref, bf16),
                       check_close(f"{tag} dW", dw, dw_ref, bf16)),
    }
    # a second run must give the same bits (no atomics, fixed-order dW)
    dx2, dw2 = sk.span_backward(g, x, w, plan)
    out2 = sk.span_forward(x, w, plan)
    torch.cuda.synchronize()
    if not (torch.equal(out, out2) and torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        fail(f"{tag}: two kernel runs differ")
    if timing:
        reps = 20
        fwd_k = lambda: sk.span_forward(x, w, plan)
        fwd_p = lambda: sk.span_forward_plain(x, w, plan)
        bwd_k = lambda: sk.span_backward(g, x, w, plan)
        bwd_p = lambda: sk.span_backward_plain(g, x, w, plan)
        for f in (fwd_k, fwd_p, bwd_k, bwd_p):
            f()
        # plain, kernel, kernel, plain
        p1, k1 = cuda_time_ms(fwd_p, reps), cuda_time_ms(fwd_k, reps)
        k2, p2 = cuda_time_ms(fwd_k, reps), cuda_time_ms(fwd_p, reps)
        res["fwd_ms"], res["fwd_plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
        p1, k1 = cuda_time_ms(bwd_p, reps), cuda_time_ms(bwd_k, reps)
        k2, p2 = cuda_time_ms(bwd_k, reps), cuda_time_ms(bwd_p, reps)
        res["bwd_ms"], res["bwd_plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"  {tag} times: span_forward {res['fwd_ms']:.4f} ms "
              f"(plain {res['fwd_plain_ms']:.4f} ms), span_backward "
              f"{res['bwd_ms']:.4f} ms (plain {res['bwd_plain_ms']:.4f} ms)",
              flush=True)
    return res


def conv_autograd_check(rng):
    """rgcn_conv values and gradients: kernels on the card vs the plain
    versions on the CPU, same inputs."""
    import torch
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
        build_rel_edges, init_rgcn_layer, rgcn_conv)

    n, e, slots, d_in, d_out = 700, 5000, 9, 63, 11
    src, dst, typ = random_graph(rng, n, e, slots, n_live=600,
                                 live_rels=[0, 1, 3, 4, 6])
    gen = torch.Generator().manual_seed(0)
    layer = init_rgcn_layer(gen, slots, d_in, d_out)
    x0 = torch.randn((n, d_in), generator=gen)
    gout = torch.randn((n, d_out), generator=gen)
    results = {}
    for dev in ("cuda", "cpu"):
        plan = build_rel_edges(src, dst, typ, n, slots, device=dev)
        lay = init_rgcn_layer(gen, slots, d_in, d_out).to(dev)
        lay.load_state_dict(layer.state_dict())
        x = x0.to(dev).requires_grad_(True)
        out = rgcn_conv(x, plan, lay)
        (out * gout.to(dev)).sum().backward()
        results[dev] = [t.detach().cpu() for t in
                        (out, x.grad, lay.weight.grad, lay.root.grad, lay.bias.grad)]
    for name, got, ref in zip(("out", "dx", "dweight", "droot", "dbias"),
                              results["cuda"], results["cpu"]):
        check_close(f"conv autograd {name}", got, ref, bf16=False)


def main() -> None:
    phase("1 environment")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, PKG, "csrc")):
        fail(f"{PKG}/ is not beside this script: run it from a checkout")
    sys.path.insert(0, ROOT)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    phase("2 build")
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk

    t0 = time.perf_counter()
    sk._kernels()
    print(f"built and loaded {sk.build_kernels().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in sk.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    phase("3 kernels vs plain versions")
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges

    rng = np.random.default_rng(0)
    # edge cases: nodes 400..499 have no edges, relations 1, 4, 6, 8 none
    src, dst, typ = random_graph(rng, 500, 3000, 9, n_live=400,
                                 live_rels=[0, 2, 3, 5, 7])
    small = build_rel_edges(src, dst, typ, 500, 9, device="cuda")
    for d_in, d_out in ((63, 4), (63, 11), (11, 63)):
        for dtype in (torch.float32, torch.bfloat16):
            compare_kernels(sk, small, d_in, d_out, dtype, rng,
                            f"small {d_in}->{d_out} {str(dtype)[6:]}")
    # wide rows and 30 relations: W takes several shared-memory passes
    src, dst, typ = random_graph(rng, 400, 6000, 30)
    wide = build_rel_edges(src, dst, typ, 400, 30, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        compare_kernels(sk, wide, 128, 32, dtype, rng,
                        f"small 128->32 30 slots {str(dtype)[6:]}")
    t0 = time.perf_counter()
    src, dst, typ = random_graph(np.random.default_rng(0), N, E, SLOTS)
    plan = build_rel_edges(src, dst, typ, N, SLOTS, device="cuda")
    print(f"bench-shape plan built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    bench = {}
    for d_in, d_out, layer in ((D, HL, "layer1"), (HL, C, "layer2")):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            bench[(layer, name)] = compare_kernels(
                sk, plan, d_in, d_out, dtype, rng,
                f"bench {layer} {d_in}->{d_out} {name}", timing=True)
    conv_autograd_check(rng)

    phase("4 trainer at the bench shape")
    from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph
    from scaling_rgcn_training_tpu_torch.models.heads import init_emb_model
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss
    from scaling_rgcn_training_tpu_torch.train.trainer import Trainer

    lab_rng = np.random.default_rng(1)
    labelled = lab_rng.choice(N, 4096 + 1024, replace=False)
    onehot = np.eye(C, dtype=np.float32)
    graph = DeviceGraph(
        edges=plan,
        x_train=torch.as_tensor(labelled[:4096], dtype=torch.int64).cuda(),
        y_train=torch.as_tensor(onehot[np.arange(4096) % C]).cuda(),
        x_val=torch.as_tensor(labelled[4096:], dtype=torch.int64).cuda(),
        y_val=torch.as_tensor(onehot[np.arange(1024) % C]).cuda())
    step_ms = {}
    sk.reset_launch_counts()
    for cd in (None, "bfloat16"):
        name = cd or "float32"
        trainer = Trainer(None, HL, EPOCHS, D, lr=0.01, weight_d=5e-5, seed=0,
                          device="cuda", compute_dtype=cd)
        model = init_emb_model(trainer.gen, SLOTS, HL, C, N, D, device="cuda")
        before = dict(sk.LAUNCHES)
        stamps = []

        def on_epoch(epoch):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        torch.cuda.reset_peak_memory_stats()
        _, accs, losses, _, _ = trainer.fit(model, graph, bce_loss, "sigmoid",
                                            sum_graph=False, verbose=False,
                                            on_epoch=on_epoch)
        peak = torch.cuda.max_memory_allocated() / 2**20
        if len(losses) != EPOCHS or not all(np.isfinite(losses)):
            fail(f"trainer {name}: losses {losses}")
        for k in ("span_forward", "span_backward"):
            if sk.LAUNCHES[k] - before[k] < 2 * EPOCHS:
                fail(f"trainer {name}: {k} launched "
                     f"{sk.LAUNCHES[k] - before[k]} times in {EPOCHS} steps")
        steps = np.diff(stamps) * 1e3
        step_ms[name] = statistics.median(steps[WARMUP:])
        print(f"  trainer {name}: {step_ms[name]:.3f} ms/step (median of "
              f"steps {WARMUP}..{EPOCHS - 1}; each step = validation eval + "
              f"loss/grad + Adam), loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
              f"val acc {accs[0]:.4f} -> {accs[-1]:.4f}, peak "
              f"{peak:.0f} MiB, launches {dict(sk.LAUNCHES)}", flush=True)
    launches = dict(sk.LAUNCHES)

    phase("5 CLI on the GPU")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_cli_") as tmp:
        cmd = [sys.executable, "-m", f"{PKG}.main", "-dataset", "SYNTH",
               "-exp", "summation", "-epochs", "5", "-i", "1",
               "-synth_entities", "20000", "-synth_degree", "8",
               "-device", "cuda", "-data_root", os.path.join(tmp, "data"),
               "-results_root", os.path.join(tmp, "results")]
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        tail = "\n".join(res.stdout.splitlines()[-12:])
        print(tail, flush=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            fail(f"CLI exited {res.returncode}")
        reports = [os.path.join(d, f)
                   for d, _, fs in os.walk(os.path.join(tmp, "results"))
                   for f in fs if f.endswith(".json")]
        if not any(os.path.basename(r).startswith("report_") for r in reports):
            fail(f"CLI wrote no results JSON ({reports})")
        print(f"  CLI ok in {time.perf_counter() - t0:.1f} s: "
              f"{sorted(os.path.basename(r) for r in reports)}", flush=True)

    src_path = f"{PKG}/csrc/span_kernels.cu"
    kernels = []
    for kname, key, replaces in (
            ("span_forward", "fwd", "scaling_rgcn_training_tpu/ops/span_kernels.py:425"),
            ("span_backward", "bwd", "scaling_rgcn_training_tpu/ops/span_kernels.py:542")):
        b = bench[("layer1", "float32")]
        kernels.append({
            "name": kname, "route": "cuda", "source": src_path,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(v[f"{key}_err"] for v in bench.values()),
            "ms": b[f"{key}_ms"], "plain_ms": b[f"{key}_plain_ms"]})
    print(json.dumps({"bench_shape_ms": {
        f"{layer} {dt}": {k: v for k, v in r.items() if k.endswith("ms")}
        for (layer, dt), r in bench.items()}, "step_ms": step_ms}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
