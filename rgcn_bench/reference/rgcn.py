"""Plain R-GCN training steps: the configuration's head
(``head_<head>.py``, the front that feeds the trunk) and trunk
(``trunk_<trunk>.py``, the conv layers, written per relation with
``index_select`` and ``index_add``) over the graph's edges; the
cross-entropy of the configuration's dataset; the validation metrics
(subset accuracy, weighted and macro F1 of one-hot argmax predictions,
sklearn's ``zero_division=0``); Adam with coupled L2, written out.

Everything is derived here from the triples: the inverse edges (relation
``2r`` subject -> object, ``2r + 1`` back), the mean coefficients
``1 / deg_r(dst)`` and the per-relation edge lists. The reference runs in
float64 (``precision="float64"``), so that its own rounding stays far
below the float32 program's. ``precision="tf32"`` computes in float32 and
rounds both operands of every product (forward and backward) to TF32's
10-bit mantissa: the control, one precision below the configuration's
float32.

A fit starts from the initial parameters, or from a ``State`` (Adam's
state after some updates), so that a step the program replays can be
followed from the program's own state.

Faults for the limits' readings (``fault``): ``"half_batch"``, the loss
over the first half of the training rows; ``"late_eval"``, the validation
metrics read after the update instead of before it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PRECISIONS = ("float64", "tf32")
FAULTS = (None, "half_batch", "late_eval")


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest value with a 10-bit mantissa."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _round_tf32(a) @ _round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return (g @ _round_tf32(b).transpose(-1, -2),
                _round_tf32(a).transpose(-1, -2) @ g)


def product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision``."""
    return _TF32Product.apply(a, b) if precision == "tf32" else a @ b


@dataclasses.dataclass
class Edges:
    """Edges sorted by relation slot: ``src``, ``dst`` (int64), ``norm``
    (float32) ``[E]`` and the ``(slot, lo, hi)`` ranges of each slot."""

    src: torch.Tensor
    dst: torch.Tensor
    norm: torch.Tensor
    slots: List[Tuple[int, int, int]]


def build_edges(subj: np.ndarray, rel: np.ndarray, obj: np.ndarray,
                num_nodes: int, device) -> Edges:
    """Each triple as a forward edge of slot ``2r`` and an inverse edge of
    slot ``2r + 1``, with ``norm = 1 / deg_slot(dst)``."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                  device=device)
    s, r, o = t(subj), t(rel), t(obj)
    src, dst, typ = torch.cat([s, o]), torch.cat([o, s]), \
        torch.cat([2 * r, 2 * r + 1])
    _, inv, counts = torch.unique(typ * num_nodes + dst, return_inverse=True,
                                  return_counts=True)
    norm = 1.0 / counts[inv].to(torch.float32)
    order = torch.argsort(typ, stable=True)
    src, dst, typ, norm = src[order], dst[order], typ[order], norm[order]
    sizes = torch.bincount(typ).tolist()
    ranges, lo = [], 0
    for slot, size in enumerate(sizes):
        if size:
            ranges.append((slot, lo, lo + size))
        lo += size
    return Edges(src, dst, norm, ranges)


def uniform(shape, bound: float, gen: torch.Generator, device) -> torch.Tensor:
    """U(-bound, bound) float32, one draw on ``device``."""
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound


def cross_entropy(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp(z) - z[class]`` over the rows."""
    picked = logits.gather(1, classes[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=1) - picked).mean()


def metrics(pred: np.ndarray, classes: np.ndarray,
            num_classes: int) -> Tuple[float, float, float]:
    """(subset accuracy, weighted F1, macro F1) of the predicted classes
    ``pred`` (one-hot argmax predictions) against the one-hot labels
    ``classes``; a class with no true and no predicted row scores F1 0."""
    tp = np.bincount(classes[pred == classes], minlength=num_classes)
    n_pred = np.bincount(pred, minlength=num_classes)
    support = np.bincount(classes, minlength=num_classes)
    prec = np.where(n_pred > 0, tp / np.maximum(n_pred, 1), 0.0)
    rec = np.where(support > 0, tp / np.maximum(support, 1), 0.0)
    f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec,
                                                            1e-30), 0.0)
    weighted = float((f1 * support).sum() / max(support.sum(), 1))
    return float((pred == classes).mean()), weighted, float(f1.mean())


@dataclasses.dataclass
class Readings:
    """What a fit's first step gives the comparison: each step's loss and
    validation ``(accuracy, weighted F1, macro F1)``, the first step's
    gradient as Adam gets it (with the coupled L2 term) and the parameters
    after its update, by parameter name."""

    losses: List[float]
    val: List[Tuple[float, float, float]]
    grad1: Dict[str, torch.Tensor]
    params1: Dict[str, torch.Tensor]
    # the reference's validation logits of each step (float64)
    val_logits: Optional[List[np.ndarray]] = None


@dataclasses.dataclass
class State:
    """Adam's state after ``step`` updates, by trainable parameter name:
    the parameters and the first and second moments."""

    step: int
    params: Dict[str, torch.Tensor]
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]


def head_module(config: Dict[str, Any]):
    return importlib.import_module(f"rgcn_bench.reference.head_{config['head']}")


def trunk_name(config: Dict[str, Any]) -> str:
    """The configuration's ``"trunk"``; ``dense`` where it names none."""
    return config.get("trunk", "dense")


def trunk_module(config: Dict[str, Any]):
    """``reference/trunk_<trunk>.py``: the trunk's forward, initial
    parameters and cost counts (the interface: ``trunk_dense.py``)."""
    return importlib.import_module(
        f"rgcn_bench.reference.trunk_{trunk_name(config)}")


def fit(config: Dict[str, Any], edges: Edges, labels: Dict[str, np.ndarray],
        params0: Dict[str, torch.Tensor], steps: int,
        dropout_masks: Optional[Callable[[Sequence[int]], torch.Tensor]] = None,
        precision: str = "float64", fault: Optional[str] = None,
        state: Optional[State] = None) -> Readings:
    """``steps`` epochs of the configuration's fit from ``params0``, or
    from ``state`` (its trainable parameters and moments; the frozen ones
    from ``params0``): the validation forward (no dropout) before the
    update, the loss's forward (dropout masks from ``dropout_masks(shape)``,
    one call a step), the gradients by autograd and Adam written out."""
    if precision not in PRECISIONS or fault not in FAULTS:
        raise ValueError(f"precision {precision!r}, fault {fault!r}")
    head, trunk = head_module(config), trunk_module(config)
    device = next(iter(params0.values())).device
    frozen = set(config.get("frozen", ()))
    dtype = torch.float64 if precision == "float64" else torch.float32
    start = dict(params0, **(state.params if state is not None else {}))
    params = {k: v.detach().to(device, dtype, copy=True).requires_grad_(
        k not in frozen) for k, v in start.items()}
    trainable = [k for k in params if k not in frozen]
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    x_train, y_train = t(labels["x_train"]), t(labels["y_train"])
    x_val = t(labels["x_val"])
    if fault == "half_batch":
        half = x_train.shape[0] // 2
        x_train, y_train = x_train[:half], y_train[:half]
    b1, b2 = config["adam_betas"]
    lr, wd, eps = config["lr"], config["weight_decay"], config["adam_eps"]
    if state is None:
        moments = {k: (torch.zeros_like(params[k]), torch.zeros_like(params[k]))
                   for k in trainable}
    else:
        moments = {k: tuple(t[k].to(device, dtype, copy=True)
                            for t in (state.exp_avg, state.exp_avg_sq))
                   for k in trainable}
    done = state.step if state is not None else 0
    forward = lambda train: trunk.forward(
        head.front(params, config, precision,
                   dropout_masks if train else None), params, edges,
        precision)

    val_logits = []

    def validate():
        with torch.no_grad():
            val_logits.append(forward(False).index_select(0, x_val).to(
                torch.float64).cpu().numpy())

    losses, grad1, params1 = [], {}, {}
    for step in range(done + 1, done + steps + 1):
        if fault != "late_eval":
            validate()
        loss = cross_entropy(forward(True).index_select(0, x_train), y_train)
        grads = torch.autograd.grad(loss, [params[k] for k in trainable])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(trainable, grads):
                p, (m, v) = params[k], moments[k]
                g = g + wd * p
                if step == done + 1:
                    grad1[k] = g.clone()
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m / (1 - b1 ** step)
                v_hat = v / (1 - b2 ** step)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
        if step == done + 1:
            params1 = {k: params[k].detach().clone() for k in trainable}
        del grads, loss
        if fault == "late_eval":
            validate()
    val = [metrics(z.argmax(axis=1), labels["y_val"], config["num_classes"])
           for z in val_logits]
    return Readings(losses, val, grad1, params1, val_logits)
