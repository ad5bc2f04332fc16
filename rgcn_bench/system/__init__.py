"""The system under test: the port's ``Trainer``, ``DeviceGraph`` and
model, built from a run's inputs as the CLI's fine-tune builds them
(``main.py`` -> ``Trainer.train_original`` -> ``Trainer.fit``), and the
readings of a fit's first steps for the comparison. Each head's model is
built in ``head_<head>.py`` around the conv layers that the
configuration's trunk builds in ``trunk_<trunk>.py``."""

from __future__ import annotations

import dataclasses
import importlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from rgcn_bench import inputs as bench_inputs
from rgcn_bench.reference.rgcn import Readings, State, trunk_name


@dataclasses.dataclass
class Program:
    trainer: Any
    graph: Any
    model: torch.nn.Module
    loss_fn: Callable
    activation: str
    frozen: List[str]
    plan_build_s: float

    def fit(self, epochs: int, on_epoch: Optional[Callable[[int], None]]):
        """One fine-tune of ``epochs`` epochs, as ``train_original`` runs
        it; returns ``Trainer.fit``'s ``(model, accuracies, losses,
        weighted F1s, macro F1s)``."""
        self.trainer.epochs = epochs
        return self.trainer.fit(self.model, self.graph, self.loss_fn,
                                self.activation, sum_graph=False,
                                frozen=self.frozen, verbose=False,
                                on_epoch=on_epoch)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(config: Dict[str, Any], inp: bench_inputs.Inputs,
          params: Dict[str, torch.Tensor], device) -> Program:
    """The program over the run's graph, labels and initial parameters
    (which the model takes over and trains in place). ``plan_build_s``:
    the host plan and its placement (``graphs/device.py``
    ``build_device_graph``), the card synchronised."""
    from scaling_rgcn_training_tpu_torch.graphs.device import (
        build_device_graph)
    from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
    from scaling_rgcn_training_tpu_torch.train.losses import get_loss
    from scaling_rgcn_training_tpu_torch.train.trainer import Trainer

    graph = Graph(config["dataset"])
    graph.num_nodes = int(config["num_entities"])
    graph.num_edges = int(config["num_triples"])
    graph.relations = {f"relation{i}": i
                       for i in range(config["num_relations"])}
    graph.edge_src, graph.edge_dst, graph.edge_type = \
        bench_inputs.program_edges(inp.triples)
    onehot = np.eye(config["num_classes"], dtype=np.float32)
    for split in ("train", "val"):
        setattr(graph, f"x_{split}", inp.labels[f"x_{split}"])
        setattr(graph, f"y_{split}", onehot[inp.labels[f"y_{split}"]])
    t0 = time.perf_counter()
    dev_graph = build_device_graph(graph, device)
    _sync(device)
    plan_build_s = time.perf_counter() - t0
    dtype = config["compute_dtype"]
    # the model is built here, so the trainer's widths (read only where
    # the trainer builds a model itself) stay unset
    trainer = Trainer(None, None, config["epochs"], None, config["lr"],
                      config["weight_decay"], seed=inp.trainer_seed,
                      device=device,
                      compute_dtype=None if dtype == "float32" else dtype)
    part = lambda kind, name: importlib.import_module(
        f"rgcn_bench.system.{kind}_{name}")
    layers = part("trunk", trunk_name(config)).layers(params)
    model = part("head", config["head"]).model(params, layers)
    loss_fn, activation = get_loss(config["dataset"], sum_model=False)
    return Program(trainer, dev_graph, model, loss_fn, activation,
                   list(config.get("frozen", ())), plan_build_s)


def first_steps(program: Program, config: Dict[str, Any], epochs: int
                ) -> Tuple[Readings, Readings, State]:
    """A fit of ``epochs`` epochs (the eager warm-ups, the capture, the
    replays) and what the comparison reads of it, copied to the host:

    - ``start``, its first step: the loss and validation metrics as the
      fit returns them, the gradient as Adam holds it after the step (its
      first moment over ``1 - beta1``) and the parameters after it;
    - ``replay``, the same of the second replay after the capture (epoch
      ``WARMUP + 1``: a value fixed at the capture differs there from the
      step's own), its gradient worked out from the first moments before
      and after it;
    - ``state``, Adam's state before that step (parameters, moments, the
      number of updates done), from which the reference follows it.
    """
    from scaling_rgcn_training_tpu_torch.train.step_graph import WARMUP

    judged = WARMUP + 1
    if epochs <= judged:
        raise ValueError(f"a fit of {epochs} epochs has no epoch {judged}")
    beta1 = config["adam_betas"][0]
    names = {p: name for name, p in program.model.named_parameters()}
    optimizers, start, replay = [], {}, {}
    stamps = [time.perf_counter()]
    host = lambda t: t.detach().to("cpu", copy=True)

    def on_step(opt, args, kwargs):
        if not optimizers:
            optimizers.append(opt)

    def read(key):
        return {names[p]: host(s[key]) for p, s in
                optimizers[0].state.items()}

    def on_epoch(epoch):
        stamps.append(time.perf_counter())
        if epoch not in (0, judged - 1, judged):
            return
        params = {names[p]: host(p) for p in optimizers[0].state}
        if epoch == 0:
            start.update(grad={k: v / (1 - beta1)
                               for k, v in read("exp_avg").items()},
                         params=params)
        if epoch == judged - 1:
            replay.update(state=State(epoch + 1, params, read("exp_avg"),
                                      read("exp_avg_sq")))
        if epoch == judged:
            before = replay["state"].exp_avg
            replay.update(grad={k: (m.double() - beta1 * before[k].double())
                                / (1 - beta1)
                                for k, m in read("exp_avg").items()},
                          params=params)

    hook = register_optimizer_step_post_hook(on_step)
    try:
        _, accs, losses, f1_w, f1_m = program.fit(epochs, on_epoch)
    finally:
        hook.remove()
    print("set-up fit: s to each epoch's end "
          f"{[round(t - stamps[0], 2) for t in stamps[1:]]}, "
          f"{time.perf_counter() - stamps[0]:.2f} s in all",
          file=sys.stderr, flush=True)
    val = list(zip(accs, f1_w, f1_m))
    return (Readings(losses[:1], val[:1], start["grad"], start["params"]),
            Readings([losses[judged]], [val[judged]], replay["grad"],
                     replay["params"]),
            replay["state"])
