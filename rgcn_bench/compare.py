"""The comparison that decides ``correct``: two steps of the program's
set-up fit against the reference's (float64), four numbers each, every
number held to its limit (``limits/<cell>.json``):

- the start: the fit's first step (an eager warm-up), the reference from
  the initial parameters drawn from the seed;
- the replay (numbers named ``replay_<number>``): the second replay of
  the captured step, the reference from the program's own state before it
  (parameters, Adam's moments; the update count and the dropout draw
  worked out from the epoch). From the first step on, an element whose
  gradient lies near zero moves under Adam by up to ``lr`` either way, so
  two runs of the whole fit part by rounding alone; one step from a shared
  state does not, and the shared first moment makes the update's norm
  answer to the gradient's direction.

Each step's four numbers:

- ``loss``: the relative gap of the step's loss;
- ``val``: the largest gap of the step's validation accuracy,
  weighted or macro F1 from the nearest the reference allows: where a
  validation row's two best reference logits lie within ``NEAR_TIE`` of
  the row's largest logit magnitude, either class counts as the
  reference's prediction (rounding decides such a tie);
- ``grad``: by the worst leaf, the gap between the program's and the
  reference's norm of the step's gradient as Adam gets it, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
- ``change``: the same gap, by the worst leaf, of the parameters' change
  made by the step's update, leaving out leaves whose reference gradient
  is under a thousandth of the median leaf's (they move under Adam by
  round-off alone).

A leaf is a parameter, or a part of one that the head's ``SPLITS`` names
(the packed in-projection's q, k and v).
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rgcn_bench.reference.rgcn import Readings, State, head_module, metrics

STEP_NUMBERS = ("loss", "val", "grad", "change")
REPLAY = "replay_"
NUMBERS = STEP_NUMBERS + tuple(REPLAY + k for k in STEP_NUMBERS)
# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone
NOUGHT = 1e-3
# a validation row whose two best reference logits differ by less than
# this share of its largest |logit| is a near-tie (the most rows taken)
NEAR_TIE = 1e-4
_MAX_TIES = 10


def _leaves(tensors: Dict[str, torch.Tensor], splits) -> Dict[str, torch.Tensor]:
    out = {}
    for name, t in tensors.items():
        parts = splits.get(name)
        if parts is None:
            out[name] = t
            continue
        for part, chunk in zip(parts, t.chunk(len(parts), dim=0)):
            out[f"{name}.{part}"] = chunk
    return out


def _norm(t: torch.Tensor, device) -> float:
    return float(torch.linalg.vector_norm(t.to(device, torch.float64)))


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]
               ) -> Dict[str, float]:
    median = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-300)
            for k in ref}


def _val_gaps(prog: Readings, ref: Readings, classes: np.ndarray,
              num_classes: int) -> list:
    """Each step's largest gap between the program's validation metrics
    and the nearest of those the reference's predictions give with each
    near-tie row taking either of its two best classes."""
    out = []
    for got, z in zip(prog.val, ref.val_logits):
        order = np.argsort(-z, axis=1)
        rows = np.arange(z.shape[0])
        best, second = order[:, 0], order[:, 1]
        margin = (z[rows, best] - z[rows, second]) / np.maximum(
            np.abs(z).max(axis=1), 1e-300)
        ties = np.argsort(margin, kind="stable")[:_MAX_TIES]
        ties = ties[margin[ties] < NEAR_TIE]
        nearest = np.inf
        for mask in range(2 ** len(ties)):
            pred = best.copy()
            flip = ties[[(mask >> j) & 1 == 1 for j in range(len(ties))]]
            pred[flip] = second[flip]
            allowed = metrics(pred, classes, num_classes)
            nearest = min(nearest, max(abs(p - a)
                                       for p, a in zip(got, allowed)))
        out.append(float(nearest))
    return out


def numbers(config, prog: Readings, ref: Readings,
            params0: Dict[str, torch.Tensor], val_classes: np.ndarray,
            detail: Optional[dict] = None) -> Dict[str, float]:
    """The four numbers of one step's readings, the program's against the
    reference's, both from ``params0`` (on the device the norms are taken
    on); ``val_classes``: the validation rows' classes. ``detail``, if
    given, receives each leaf's gradient and change gaps."""
    splits = head_module(config).SPLITS
    device = next(iter(params0.values())).device
    g_prog = {k: _norm(v, device) for k, v in _leaves(prog.grad1,
                                                       splits).items()}
    g_ref = {k: _norm(v, device) for k, v in _leaves(ref.grad1,
                                                      splits).items()}
    if len(prog.losses) != len(ref.losses) or g_prog.keys() != g_ref.keys() \
            or prog.params1.keys() != ref.params1.keys():
        raise ValueError("the program's readings cover other steps or "
                         f"leaves: {sorted(g_prog)} vs {sorted(g_ref)}")
    losses = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]
    val = _val_gaps(prog, ref, val_classes, config["num_classes"])
    median_g = statistics.median(g_ref.values())
    moving = {k for k, v in g_ref.items() if v >= NOUGHT * median_g}
    delta = lambda ps: {k: _norm(v.to(device) - p0, device)
                        for k, v, p0 in _zip_leaves(ps, params0, splits)
                        if k in moving}
    grad = _leaf_gaps(g_prog, g_ref)
    change = _leaf_gaps(delta(prog.params1), delta(ref.params1))
    if detail is not None:
        detail.update(grad=grad, change=change)
    return {"loss": losses[0], "val": val[0], "grad": max(grad.values()),
            "change": max(change.values())}


def both(config, start: Tuple[Readings, Readings],
         replay: Tuple[Readings, Readings], params0: Dict[str, torch.Tensor],
         state: State, val_classes: np.ndarray,
         detail: Optional[dict] = None) -> Dict[str, float]:
    """The eight numbers: the start's ``(program, reference)`` readings
    from ``params0``, the replay's from ``state``."""
    device = next(iter(params0.values())).device
    before = dict(params0, **{k: v.to(device)
                              for k, v in state.params.items()})
    parts = {}
    out = numbers(config, *start, params0, val_classes, parts.setdefault(
        "start", {}))
    again = numbers(config, *replay, before, val_classes, parts.setdefault(
        "replay", {}))
    out.update({REPLAY + k: v for k, v in again.items()})
    if detail is not None:
        detail.update(parts)
    return out


def _zip_leaves(params, params0, splits):
    p0 = _leaves({k: params0[k] for k in params}, splits)
    for k, v in _leaves(params, splits).items():
        yield k, v, p0[k]


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` (every number within its limit; a NaN is not) and each
    number beside its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def print_checks(checks: Dict[str, Dict[str, float]], correct: bool) -> None:
    """Each number and its limit, as the last lines on standard error."""
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr, flush=True)
