"""Trainer: summary pre-training, transfer, full-graph fine-tuning.

Counterpart of the JAX package's ``train/trainer.py`` (reference
model/modelTrainer.py:15-116), for the summation, MLP, attention and
baseline experiments:

- ``train_summaries``: ONE shared conv trunk trained sequentially over all
  summary graphs, re-initializing the embedding per graph and recording
  each trained embedding on the host Graph (modelTrainer.py:76-82);
- ``train_original``: the model on the full graph with optional embedding
  transfer (+freeze) and weight transfer (+freeze) (modelTrainer.py:84-116);
- the epoch loop evaluates on the validation split BEFORE each update step
  (modelTrainer.py:53-59), so recorded series line up with the reference's.

Every tensor lives on the trainer's explicit ``device``; random draws come
from one ``torch.Generator`` seeded from ``seed`` (on the CPU, so a seed
gives the same initial values on every device). A ``fit`` of a model with
dropout (the attention head) draws one seed from it for a generator on
the device, which draws the dropout masks of its steps (as the JAX ``fit``
splits one key per run). Freezing leaves a parameter out of the optimizer
and out of autograd.

With ``devices`` > 1 (or an explicit ``mesh``) the graph's edges are
partitioned over a mesh (``partition``: ``"halo"`` or ``"edge"``,
``parallel/``), with an optional locality ``reorder`` of the nodes for the
halo partition; parameters and node-major activations stay on the mesh's
first device and ``rgcn_conv`` dispatches on the edges' type. The halo
partition pads the node table to ``S * n_per`` rows; embeddings (``[N, d]``,
or ``[K, N, d]`` for the attention head) enter the model through
:meth:`Trainer._pad_embedding` and leave it through
:meth:`Trainer._export_embedding`, so a seed gives every node the same
initial vector at any device count.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.graphs.dataset import Dataset
from scaling_rgcn_training_tpu_torch.graphs.device import (
    DeviceGraph, build_device_graph, model_num_nodes)
from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
from scaling_rgcn_training_tpu_torch.models import heads as model_heads
from scaling_rgcn_training_tpu_torch.ops.grouped_matmul import BACKENDS
from scaling_rgcn_training_tpu_torch.parallel.mesh import Mesh, make_mesh, use_mesh
from scaling_rgcn_training_tpu_torch.train.losses import get_loss
from scaling_rgcn_training_tpu_torch.train.metrics import (
    classification_table, evaluate, predictions)
from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer
from scaling_rgcn_training_tpu_torch.train.transfer import EMBEDDING_TRICKS

_DTYPES = {None: None, "bfloat16": torch.bfloat16}


class Trainer:
    """Same constructor surface as the reference Trainer
    (modelTrainer.py:17-24), plus ``device`` and the JAX package's
    weight-decomposition, mixed-precision, conv-backend, aggregation and
    distribution options (``backend``: the grouped matmul of the non-fused
    conv, ``"ragged"``, ``"gather"`` or ``"pallas"``; ``aggr``: ``"mean"``
    or ``"attention"``; ``devices``: a mesh of that many CUDA devices, or
    of as many virtual shards of ``device`` when it is the CPU; ``mesh``:
    an explicit mesh, e.g. S virtual shards on one card)."""

    def __init__(self, data: Optional[Dataset], hidden_l: int, epochs: int,
                 emb_dim: int, lr: float, weight_d: float, seed: int = 0,
                 device="cuda", num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 compute_dtype=None, backend: Optional[str] = None,
                 aggr: str = "mean", devices: Optional[int] = None,
                 partition: str = "halo", reorder: bool = False,
                 mesh: Optional[Mesh] = None) -> None:
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
        if backend not in (None, *BACKENDS):
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        if aggr not in ("mean", "attention"):
            raise ValueError(f"aggr {aggr!r} is not 'mean' or 'attention'")
        self.backend = backend
        self.aggr = aggr
        if mesh is None and devices and devices > 1:
            mesh = make_mesh(devices) if self.device.type == "cuda" else \
                make_mesh(devices=(self.device,) * devices)
        if mesh is not None and mesh.size > 1 and aggr != "mean":
            raise ValueError("aggr='attention' is a single-device mode")
        if partition not in ("halo", "edge"):
            raise ValueError(f"partition {partition!r} is not 'halo' or 'edge'")
        # the mesh of a multi-device run; parameters live on its first device
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            self.device = self.mesh.first
        self.partition = partition if self.mesh is not None else None
        self.reorder = bool(reorder)
        self.gen = torch.Generator().manual_seed(seed)
        self.sum_model: Optional[model_heads.EmbModel] = None
        self._device_graphs: Dict[int, Tuple[Graph, DeviceGraph]] = {}

    def _device_graph(self, graph: Graph) -> DeviceGraph:
        # keyed by id(graph), with the Graph held in the value so the id
        # stays valid as long as the entry lives
        hit = self._device_graphs.get(id(graph))
        if hit is None or hit[0] is not graph:
            hit = (graph, build_device_graph(
                graph, self.device, mesh=self.mesh, partition=self.partition,
                reorder=self.reorder))
            self._device_graphs[id(graph)] = hit
        return hit[1]

    def _mesh_scope(self):
        return contextlib.nullcontext() if self.mesh is None else \
            use_mesh(self.mesh)

    def _logits(self, model: torch.nn.Module, graph: DeviceGraph,
                train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        # the ambient mesh for rgcn_conv's dispatch
        with self._mesh_scope():
            return model(graph.edges, self.compute_dtype, self.backend,
                         self.aggr, train=train, gen=gen)

    def _pad_embedding(self, emb: torch.Tensor,
                       dev_graph: DeviceGraph) -> torch.Tensor:
        """Rows in true node order -> the model's node table on the
        trainer's device; the node axis is 0 of ``[N, d]`` and 1 of a
        stacked ``[K, N, d]``. Under a locality reorder row ``perm[i]`` of
        the result is row ``i`` of ``emb``; the halo partition's phantom
        rows are zeros."""
        axis = 1 if emb.dim() == 3 else 0
        n_model = model_num_nodes(dev_graph)
        if dev_graph.node_perm is None and n_model == emb.shape[axis]:
            return emb.to(self.device)
        moved = emb.movedim(axis, 0)
        out = moved.new_zeros((n_model, *moved.shape[1:]))
        rows = torch.arange(moved.shape[0]) if dev_graph.node_perm is None \
            else torch.as_tensor(np.asarray(dev_graph.node_perm), dtype=torch.int64)
        out[rows.to(emb.device)] = moved
        return out.movedim(0, axis).contiguous().to(self.device)

    @staticmethod
    def _export_embedding(emb: torch.Tensor, dev_graph: DeviceGraph,
                          true_n: int) -> np.ndarray:
        """The model's node table -> ``[true_n, d]`` in true node order
        (the inverse of :meth:`_pad_embedding`)."""
        arr = emb.detach().cpu().numpy()
        if dev_graph.node_perm is not None:
            return arr[np.asarray(dev_graph.node_perm)]
        return arr[:true_n]

    # -- core epoch loop (modelTrainer.py:41-74) ---------------------------

    def _dropout_generator(self, model: torch.nn.Module
                           ) -> Optional[torch.Generator]:
        """A generator on the device for the dropout masks of one ``fit``,
        seeded from ``self.gen``; None for a model without dropout (which
        then draws nothing from ``self.gen``)."""
        if not getattr(model, "dropout", 0.0):
            return None
        seed = int(torch.randint(0, 2**62, (1,), generator=self.gen))
        return torch.Generator(device=self.device).manual_seed(seed)

    def fit(self, model: torch.nn.Module, graph: DeviceGraph,
            loss_fn: Callable, activation: str, sum_graph: bool = True,
            frozen: Iterable[str] = (), verbose: bool = True,
            on_epoch: Optional[Callable[[int], None]] = None,
            ) -> Tuple[torch.nn.Module, List[float], List[float],
                       List[float], List[float]]:
        """Train ``model`` (a head of ``models/heads.py``) in place for
        ``epochs`` steps of full-batch Adam; the validation forward runs
        with ``train=False``, the loss's with ``train=True`` (dropout).

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
        gen = self._dropout_generator(model)
        losses, metrics = [], []
        for epoch in range(self.epochs):
            if not sum_graph:
                # validation eval BEFORE the update (modelTrainer.py:53-59)
                with torch.no_grad():
                    logits = self._logits(model, graph)
                    metrics.append(torch.stack(evaluate(
                        logits, graph.x_val, graph.y_val, activation)))
            logits = self._logits(model, graph, train=True, gen=gen)
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
            model.embedding = torch.nn.Parameter(self._pad_embedding(
                torch.randn((sg.num_nodes, self.emb_dim), generator=self.gen),
                dg))
            self.fit(model, dg, loss_fn, activation, sum_graph=True,
                     verbose=verbose)
            sg.embedding = self._export_embedding(model.embedding, dg,
                                                  sg.num_nodes)
        self.sum_model = model

    # -- weight transfer (modelTrainer.py:26-39) ---------------------------

    def transfer_weights(self, model: torch.nn.Module) -> None:
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
        og = self.data.orgGraph
        dev_graph = self._device_graph(og)
        model = model_heads.HEADS[head](
            self.gen, og.num_relation_slots, self.hidden_l,
            self.data.num_classes, og.num_nodes, self.emb_dim,
            num_sums=configs.get("num_sums", 1), num_bases=self.num_bases,
            num_blocks=self.num_blocks, device=self.device)
        model.embedding = torch.nn.Parameter(self._pad_embedding(
            model.embedding.detach(), dev_graph))
        frozen = set()

        if exp != "baseline" and configs.get("e_trans", False):
            embedding = EMBEDDING_TRICKS[head](og, self.data.sumGraphs,
                                               self.emb_dim, self.gen)
            model.embedding = torch.nn.Parameter(self._pad_embedding(
                embedding, dev_graph))
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
    def evaluate_test(self, model: torch.nn.Module, graph: DeviceGraph,
                      activation: str, report: bool = False
                      ) -> Tuple[float, float, float]:
        """Test-split metrics, with a per-class table when ``report``
        (modelTrainer.py:112-114)."""
        logits = self._logits(model, graph)
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
