"""Trainer: summary pre-training, transfer, full-graph fine-tuning.

Counterpart of the JAX package's ``train/trainer.py`` (reference
model/modelTrainer.py:15-116), for the summation and baseline experiments:

- ``train_summaries``: ONE shared conv trunk trained sequentially over all
  summary graphs, re-initializing the embedding per graph and recording
  each trained embedding on the host Graph (modelTrainer.py:76-82);
- ``train_original``: the model on the full graph with optional embedding
  transfer (+freeze) and weight transfer (+freeze) (modelTrainer.py:84-116);
- the epoch loop evaluates on the validation split BEFORE each update step
  (modelTrainer.py:53-59), so recorded series line up with the reference's.

Every tensor lives on the trainer's explicit ``device``; random draws come
from one ``torch.Generator`` seeded from ``seed`` (on the CPU, so a seed
gives the same initial values on every device). Freezing leaves a
parameter out of the optimizer and out of autograd.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from scaling_rgcn_training_tpu_torch.graphs.dataset import Dataset
from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph, build_device_graph
from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
from scaling_rgcn_training_tpu_torch.models import heads as model_heads
from scaling_rgcn_training_tpu_torch.train.losses import get_loss
from scaling_rgcn_training_tpu_torch.train.metrics import (
    classification_table, evaluate, predictions)
from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer
from scaling_rgcn_training_tpu_torch.train.transfer import EMBEDDING_TRICKS

_DTYPES = {None: None, "bfloat16": torch.bfloat16}


class Trainer:
    """Same constructor surface as the reference Trainer
    (modelTrainer.py:17-24), plus ``device`` and the JAX package's
    weight-decomposition and mixed-precision options."""

    def __init__(self, data: Optional[Dataset], hidden_l: int, epochs: int,
                 emb_dim: int, lr: float, weight_d: float, seed: int = 0,
                 device="cuda", num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 compute_dtype=None) -> None:
        self.data = data
        self.hidden_l = hidden_l
        self.epochs = epochs
        self.emb_dim = emb_dim
        self.lr = lr
        self.weight_d = weight_d
        self.device = torch.device(device)
        self.num_bases = num_bases
        self.num_blocks = num_blocks
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r} is not one of "
                             f"{list(_DTYPES)}")
        # mixed precision for the conv's edge streams
        self.compute_dtype = _DTYPES[compute_dtype]
        self.gen = torch.Generator().manual_seed(seed)
        self.sum_model: Optional[model_heads.EmbModel] = None
        self._device_graphs: Dict[int, Tuple[Graph, DeviceGraph]] = {}

    def _device_graph(self, graph: Graph) -> DeviceGraph:
        # keyed by id(graph), with the Graph held in the value so the id
        # stays valid as long as the entry lives
        hit = self._device_graphs.get(id(graph))
        if hit is None or hit[0] is not graph:
            hit = (graph, build_device_graph(graph, self.device))
            self._device_graphs[id(graph)] = hit
        return hit[1]

    # -- core epoch loop (modelTrainer.py:41-74) ---------------------------

    def fit(self, model: model_heads.EmbModel, graph: DeviceGraph,
            loss_fn: Callable, activation: str, sum_graph: bool = True,
            frozen: Iterable[str] = (), verbose: bool = True,
            on_epoch: Optional[Callable[[int], None]] = None,
            ) -> Tuple[model_heads.EmbModel, List[float], List[float],
                       List[float], List[float]]:
        """Train ``model`` in place for ``epochs`` steps of full-batch Adam.

        ``frozen``: names of top-level submodules / parameters
        (``embedding``, ``rgcn1``, ``rgcn2``) that get no update.
        ``on_epoch(epoch)`` is called after each step. Returns
        ``(model, val accuracies, losses, val weighted F1, val macro F1)``;
        the validation series are empty for summary graphs.
        """
        frozen = set(frozen)
        trainable = []
        for name, p in model.named_parameters():
            train = name.split(".")[0] not in frozen
            p.requires_grad_(train)
            if train:
                trainable.append(p)
        opt = make_optimizer(trainable, self.lr, self.weight_d) if trainable else None
        losses, metrics = [], []
        for epoch in range(self.epochs):
            if not sum_graph:
                # validation eval BEFORE the update (modelTrainer.py:53-59)
                with torch.no_grad():
                    logits = model(graph.edges, self.compute_dtype)
                    metrics.append(torch.stack(evaluate(
                        logits, graph.x_val, graph.y_val, activation)))
            logits = model(graph.edges, self.compute_dtype)
            loss = loss_fn(logits[graph.x_train], graph.y_train)
            if opt is not None:
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
            losses.append(loss.detach())
            if on_epoch is not None:
                on_epoch(epoch)
        losses_l = torch.stack(losses).tolist() if losses else []
        accs = f1_ws = f1_ms = []
        if metrics:
            accs, f1_ws, f1_ms = (list(s) for s in zip(*torch.stack(metrics).tolist()))
        if verbose:
            for epoch in range(self.epochs):
                if not sum_graph:
                    print(f"Accuracy on validation set = {accs[epoch]}")
                if epoch % 10 == 0:
                    print(f"Epoch: {epoch}, Loss: {losses_l[epoch]:.4f}")
        return model, accs, losses_l, f1_ws, f1_ms

    # -- summary pre-training (modelTrainer.py:76-82) ----------------------

    def train_summaries(self, configs: Dict[str, Any], verbose: bool = True) -> None:
        loss_fn, activation = get_loss(configs["dataset"], sum_model=True)
        sg0 = self.data.sumGraphs[0]
        model = model_heads.init_emb_model(
            self.gen, sg0.num_relation_slots, self.hidden_l,
            self.data.num_classes, sg0.num_nodes, self.emb_dim,
            num_bases=self.num_bases, num_blocks=self.num_blocks,
            device=self.device)
        for sg in self.data.sumGraphs:
            dg = self._device_graph(sg)
            # re-init the embedding for this summary's node count, keep trunk
            model.embedding = torch.nn.Parameter(torch.randn(
                (sg.num_nodes, self.emb_dim), generator=self.gen).to(self.device))
            self.fit(model, dg, loss_fn, activation, sum_graph=True,
                     verbose=verbose)
            sg.embedding = model.embedding.detach().cpu().numpy()
        self.sum_model = model

    # -- weight transfer (modelTrainer.py:26-39) ---------------------------

    def transfer_weights(self, model: model_heads.EmbModel) -> None:
        """Copy the summary model's trunk into ``model`` (a copy, so
        fine-tuning leaves the summary model as it was)."""
        if self.sum_model is None:
            raise RuntimeError("train_summaries must run first")
        with torch.no_grad():
            model.rgcn1.load_state_dict(self.sum_model.rgcn1.state_dict())
            model.rgcn2.load_state_dict(self.sum_model.rgcn2.state_dict())

    # -- full-graph training (modelTrainer.py:84-116) ----------------------

    def train_original(self, head: str, configs: Dict[str, Any], exp: str,
                       verbose: bool = True) -> Dict[str, Any]:
        if head not in model_heads.HEADS:
            raise NotImplementedError(
                f"the {head!r} head is not ported yet (ROADMAP.md queue 1: "
                "the MLP and attention heads)")
        og = self.data.orgGraph
        dev_graph = self._device_graph(og)
        model = model_heads.HEADS[head](
            self.gen, og.num_relation_slots, self.hidden_l,
            self.data.num_classes, og.num_nodes, self.emb_dim,
            num_bases=self.num_bases, num_blocks=self.num_blocks,
            device=self.device)
        frozen = set()

        if exp != "baseline" and configs.get("e_trans", False):
            embedding = EMBEDDING_TRICKS[head](og, self.data.sumGraphs,
                                               self.emb_dim, self.gen)
            model.embedding = torch.nn.Parameter(embedding.to(self.device))
            if configs.get("e_freeze", True):
                frozen.add("embedding")
            if verbose:
                print("Loaded pre trained embedding")

        if exp != "baseline" and configs.get("w_trans", False):
            self.transfer_weights(model)
            if not configs.get("w_grad", True):
                frozen |= {"rgcn1", "rgcn2"}
            if verbose:
                print("weight transfer done")

        loss_fn, activation = get_loss(configs["dataset"], sum_model=False)
        if verbose:
            print("Training on Orginal Graph...")
        model, accs, losses, f1_ws, f1_ms = self.fit(
            model, dev_graph, loss_fn, activation, sum_graph=False,
            frozen=frozen, verbose=verbose)

        test_acc, test_f1_w, test_f1_m = self.evaluate_test(
            model, dev_graph, activation, report=verbose)
        if verbose:
            print("ACC ON TEST SET = ", test_acc)
        return {
            "accuracy": accs, "loss": losses,
            "f1 weighted": f1_ws, "f1 macro": f1_ms,
            "test_acc": test_acc, "test_f1_weighted": test_f1_w,
            "test_f1_macro": test_f1_m, "model": model, "frozen": frozen,
        }

    @torch.no_grad()
    def evaluate_test(self, model: model_heads.EmbModel, graph: DeviceGraph,
                      activation: str, report: bool = False
                      ) -> Tuple[float, float, float]:
        """Test-split metrics, with a per-class table when ``report``
        (modelTrainer.py:112-114)."""
        logits = model(graph.edges, self.compute_dtype)
        acc, f1_w, f1_m = evaluate(logits, graph.x_test, graph.y_test, activation)
        if report:
            pred = predictions(logits, activation)[graph.x_test]
            print(classification_table(pred, graph.y_test))
        return float(acc), float(f1_w), float(f1_m)


def count_trainable_parameters(model: torch.nn.Module, frozen: Iterable[str],
                               sum_graphs: Optional[List[Graph]] = None) -> int:
    """Reference results.py:29-37: trainable params + summary embeddings."""
    frozen = set(frozen)
    total = sum(p.numel() for name, p in model.named_parameters()
                if name.split(".")[0] not in frozen)
    for sg in sum_graphs or ():
        if sg.embedding is not None:
            total += int(sg.embedding.shape[0] * sg.embedding.shape[1])
    return total
