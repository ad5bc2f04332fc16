"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m rgcn_bench.run --workload am_baseline_uniform --seed 7 \\
        --seconds 30 --trace 0

Exits non-zero, and prints no result, without a CUDA device (or with
fewer than the cell asks for), and when a module of JAX or of the JAX
package is loaded once the window has closed. The program's build caches
(``build/torch_kernels``, Triton's and PyTorch's extension caches) stay
inside the checkout. The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from rgcn_bench import spec  # noqa: E402

# top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "scaling_rgcn_training_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden (whole names: the
    port's ``scaling_rgcn_training_tpu_torch`` is not the JAX package)."""
    return sorted({name.split(".")[0] for name in sys.modules} &
                  set(FORBIDDEN))


def _caches() -> None:
    build = spec.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from rgcn_bench import compare, harness

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    compare.print_checks(result["checks"], result["correct"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
