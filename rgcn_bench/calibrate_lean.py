"""``calibrate.py``'s readings for a cell whose float64 readings do not fit
on the card all at once: the featureless basis cell's reference fit keeps
10.7 GB of readings (its 667M-float bases' gradient and update in
float64), and ``calibrate.py`` holds eight such fits' before it compares.
Here each step is compared as soon as its fits return: the reference's
first step, then the program and each variant against it, then the same
from the program's state before the judged replay. At most two reference
fits' readings are alive at once, as in a run's own comparison
(``harness._compare``). The same readings, numbers and output lines as
``calibrate.py``:

    python3 -m rgcn_bench.calibrate_lean --workload am_rgcn_paper_basis \\
        --seeds 11,12,13 --controls 3
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from rgcn_bench import calibrate, compare, harness, inputs, spec, system
from rgcn_bench.reference import rgcn


def readings(cell: spec.Cell, seed: int, controls: bool, device) -> list:
    config = cell.config
    inp = inputs.make(cell, seed)
    program = system.build(config, inp, inputs.params(config, inp, device),
                           device)
    steps = system.first_steps(program, config, harness.SETUP_EPOCHS)
    state = steps[2]
    del program
    gc.collect()
    torch.cuda.empty_cache()
    params0 = inputs.params(config, inp, device)
    edges = rgcn.build_edges(*inp.triples, config["num_entities"], device)
    before = dict(params0, **{k: v.to(device)
                              for k, v in state.params.items()})
    variants = calibrate.VARIANTS if controls else ()
    out = {kind: ({}, {}) for kind in
           ("program", *(v[0] for v in variants))}
    for prefix, prog, at, p0 in (("", steps[0], None, params0),
                                 (compare.REPLAY, steps[1], state, before)):
        def fit(precision="float64", fault=None):
            skip = at.step if at is not None else 0
            return rgcn.fit(config, edges, inp.labels, params0, 1,
                            inputs.dropout_masks(config, inp, device, skip),
                            precision, fault, at)

        ref = fit()
        for kind, precision, fault in (("program", None, None), *variants):
            other = prog if kind == "program" else fit(precision, fault)
            detail = {}
            values = compare.numbers(config, other, ref, p0,
                                     inp.labels["y_val"], detail)
            out[kind][0].update({prefix + k: v for k, v in values.items()})
            out[kind][1]["replay" if prefix else "start"] = detail
            del other
        del ref
        gc.collect()
    return [(kind, dict(values, detail=detail))
            for kind, (values, detail) in out.items()]


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
        print("calibrate_lean needs a CUDA device", file=sys.stderr)
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
