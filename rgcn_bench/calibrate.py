"""The readings the limits of ``limits/<cell>.json`` are set from, at the
cell's own size, in one process (the plan build is most of a run's
set-up):

- for every seed, the program's eight numbers against the reference (a
  sound run: the run's own set-up fit, no window);
- for the first ``--controls`` seeds, the control (the reference in TF32,
  one precision below the configuration's float32) and the reference with
  each planted fault (``half_batch``, ``late_eval``), in the program's
  place, at both steps the comparison reads (the replay from the
  program's state); the reference they are held to runs in float64.

    python3 -m rgcn_bench.calibrate --workload am_baseline_uniform \\
        --seeds 11,12,13 --controls 3

One JSON line a reading on standard output: ``seed``, ``kind``
(``program``, ``tf32``, ``half_batch``, ``late_eval``), the numbers and
their ``detail`` (each leaf's gradient and change gaps at each step).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from rgcn_bench import compare, harness, inputs, spec, system
from rgcn_bench.reference import rgcn

VARIANTS = (("tf32", "tf32", None), ("half_batch", "float64", "half_batch"),
            ("late_eval", "float64", "late_eval"))


def readings(cell: spec.Cell, seed: int, controls: bool, device) -> list:
    config = cell.config
    inp = inputs.make(cell, seed)
    program = system.build(config, inp, inputs.params(config, inp, device),
                           device)
    start, replay, state = system.first_steps(program, config,
                                              harness.SETUP_EPOCHS)
    del program
    gc.collect()
    torch.cuda.empty_cache()
    params0 = inputs.params(config, inp, device)
    edges = rgcn.build_edges(*inp.triples, config["num_entities"], device)

    def fit(at, precision="float64", fault=None):
        skip = at.step if at is not None else 0
        return rgcn.fit(config, edges, inp.labels, params0, 1,
                        inputs.dropout_masks(config, inp, device, skip),
                        precision, fault, at)

    refs = (fit(None), fit(state))
    out = []
    variants = VARIANTS if controls else ()
    for kind, other in [("program", (start, replay)),
                        *((kind, (fit(None, precision, fault),
                                  fit(state, precision, fault)))
                          for kind, precision, fault in variants)]:
        detail = {}
        values = compare.both(config, (other[0], refs[0]),
                              (other[1], refs[1]), params0, state,
                              inp.labels["y_val"], detail)
        out.append((kind, dict(values, detail=detail)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--controls", type=int, default=3,
                    help="seeds (the first) that also read the control and "
                    "the faults")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for kind, values in readings(cell, seed, i < args.controls, "cuda"):
            print(json.dumps({"seed": seed, "kind": kind, **values}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
