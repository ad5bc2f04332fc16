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
first device and ``rgcn_conv`` dispatches on the edges' type (the halo
conv splits the rows into its node-sharded layout, ``parallel/mesh.py``
``NodeRows``, and gathers its result back: the conversion happens at the
conv's edges, the Trainer's own tensors keep one tensor each). The halo
partition pads the node table to ``S * n_per`` rows; embeddings (``[N, d]``,
or ``[K, N, d]`` for the attention head) enter the model through
:meth:`Trainer._pad_embedding` and leave it through
:meth:`Trainer._export_embedding`, so a seed gives every node the same
initial vector at any device count.

Checkpoints (``ckpt_dir``, ``ckpt_every``; ``utils/checkpoint.py``): the
fine-tuning ``fit`` of ``train_original`` writes its state every
``ckpt_every`` epochs to ``{ckpt_dir}/fit_{dataset}_{exp}[_{tag}].npz`` and
resumes from that file when it exists, on the unbroken run's trajectory
bit for bit: the parameters and Adam's moments in true node order, Adam's
step, the dropout generator's state and the metric series.
``train_summaries(save_path=...)`` and :meth:`Trainer.load_summaries`
keep the summary pre-training on disk. ``plan_cache``: the directory of
the on-disk plan cache (``utils/plancache.py``).
"""

from __future__ import annotations

import contextlib
import os
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
from scaling_rgcn_training_tpu_torch.train.step_graph import (
    CudaStepGraph, StepGraph, describe, step_route)
from scaling_rgcn_training_tpu_torch.train.transfer import EMBEDDING_TRICKS
from scaling_rgcn_training_tpu_torch.utils.checkpoint import (
    checkpoint_exists, load_checkpoint, load_transfer_state, save_checkpoint,
    save_transfer_state)
from scaling_rgcn_training_tpu_torch.utils import tracing
from scaling_rgcn_training_tpu_torch.utils.tracing import mark, span

_DTYPES = {None: None, "bfloat16": torch.bfloat16}


class Trainer:
    """Same constructor surface as the reference Trainer
    (modelTrainer.py:17-24), plus ``device`` and the JAX package's
    weight-decomposition, mixed-precision, conv-backend, aggregation and
    distribution options (``backend``: the grouped matmul of the non-fused
    conv, ``"ragged"``, ``"gather"`` or ``"pallas"``; ``aggr``: ``"mean"``
    or ``"attention"``; ``devices``: a mesh of that many CUDA devices, or
    of as many virtual shards of ``device`` when it is the CPU; ``mesh``:
    an explicit mesh, e.g. S virtual shards on one card; ``ckpt_dir``,
    ``ckpt_every`` and ``plan_cache``: see the module)."""

    def __init__(self, data: Optional[Dataset], hidden_l: int, epochs: int,
                 emb_dim: int, lr: float, weight_d: float, seed: int = 0,
                 device="cuda", num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 compute_dtype=None, backend: Optional[str] = None,
                 aggr: str = "mean", devices: Optional[int] = None,
                 partition: str = "halo", reorder: bool = False,
                 mesh: Optional[Mesh] = None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0,
                 plan_cache: Optional[str] = None) -> None:
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
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt_tag = ""              # set per iteration by the CLI
        self.plan_cache = plan_cache
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
                reorder=self.reorder, plan_cache=self.plan_cache))
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
        """The model's node table -> ``true_n`` rows in true node order,
        on the node axis of :meth:`_pad_embedding` (the inverse of it)."""
        arr = emb.detach().cpu().numpy()
        rows = np.arange(true_n) if dev_graph.node_perm is None \
            else np.asarray(dev_graph.node_perm)
        return np.take(arr, rows, axis=1 if arr.ndim == 3 else 0)

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

    def step_route(self) -> str:
        """The route of :meth:`fit`'s step (``train/step_graph.py``):
        ``"graph"`` on one card (a mesh of virtual shards of one card
        included), ``"eager"`` on the CPU, over several cards, or with
        ``RGCN_EAGER_STEP`` set."""
        devices = self.mesh.devices if self.mesh is not None else (self.device,)
        return step_route(devices)

    def fit(self, model: torch.nn.Module, graph: DeviceGraph,
            loss_fn: Callable, activation: str, sum_graph: bool = True,
            frozen: Iterable[str] = (), verbose: bool = True,
            on_epoch: Optional[Callable[[int], None]] = None,
            ckpt_path: Optional[str] = None,
            ) -> Tuple[torch.nn.Module, List[float], List[float],
                       List[float], List[float]]:
        """Train ``model`` (a head of ``models/heads.py``) in place for
        ``epochs`` steps of full-batch Adam; the validation forward runs
        with ``train=False``, the loss's with ``train=True`` (dropout).
        Each epoch is one call of the step function, captured as a CUDA
        graph and replayed on one card (:meth:`step_route`,
        ``train/step_graph.py``), the counterpart of the JAX ``fit``'s
        ``lax.scan``.

        ``frozen``: names of top-level submodules / parameters
        (``embedding``, ``rgcn1``, ``rgcn2``) that get no update.
        ``on_epoch(epoch)`` is called after each step (and after its
        checkpoint). With ``ckpt_path`` and ``ckpt_every`` > 0 the state
        is written after every ``ckpt_every`` epochs and after the last,
        and an existing file at ``ckpt_path`` is resumed from (before the
        warm-up and the capture). Returns ``(model, val accuracies,
        losses, val weighted F1, val macro F1)``; the validation series
        are empty for summary graphs.

        The fit runs in a ``fit`` span of the recorder
        (``utils/tracing.py``): ``fit.prepare`` (the optimizer, the dropout
        generator, a resume, the step function and its graph, the clock
        offset of the step's device stamps), the step graph's spans,
        ``fit.callback`` around each ``on_epoch`` (the caller's time, not
        the program's), ``fit.drain`` (the card finishing the queued
        steps) and ``fit.readback`` (the series and the stamps to the
        host; the stamped epochs go to the recorder). With ``verbose``
        a fit that replayed prints its step spans' medians and its start
        (``tracing.fit_line``).
        """
        with tracing.fit_span() as fit_id:
            with span("fit.prepare"):
                frozen = set(frozen)
                trainable = {}
                for name, p in model.named_parameters():
                    train = name.split(".")[0] not in frozen
                    p.requires_grad_(train)
                    if train:
                        trainable[name] = p
                opt = make_optimizer(list(trainable.values()), self.lr,
                                     self.weight_d) if trainable else None
                gen = self._dropout_generator(model)
                every = self.ckpt_every if ckpt_path and self.ckpt_every > 0 \
                    else 0
                done: Dict[str, List[float]] = {k: [] for k in _SERIES}
                start = 0
                if every and checkpoint_exists(ckpt_path):
                    start, done = self._restore_fit(ckpt_path, model, graph,
                                                    trainable, opt, gen)
                step = self._step_fn(model, graph, loss_fn, activation,
                                     sum_graph, opt, gen)
                route = self.step_route()
                if verbose and self.device.type == "cuda":
                    print(f"train step: {describe(route)}")
                cuda_graph = CudaStepGraph(
                    self.device, [gen] if gen is not None else ()) \
                    if route == "graph" else None
                loop = StepGraph(step, self.epochs - start,
                                 1 if sum_graph else 4, self.device,
                                 cuda_graph, params=trainable.values())
                offset, uncertainty = tracing.clock_offset(self.device)
                tracing.note_fit(fit_id, clock_offset_ns=offset,
                                 clock_uncertainty_ns=uncertainty)
            with loop:
                saved = 0
                for epoch in range(start, self.epochs):
                    loop.run()
                    if every and ((epoch + 1 - start) % every == 0
                                  or epoch + 1 == self.epochs):
                        done = self._save_fit(ckpt_path, epoch + 1, model,
                                              graph, trainable, opt, gen,
                                              done, loop.rows(saved,
                                                              loop.done))
                        saved = loop.done
                    if on_epoch is not None:
                        with span("fit.callback"):
                            on_epoch(epoch)
                loop.drain()
                with span("fit.readback"):
                    series = _append_series(done, loop.rows(saved, loop.done))
                    tracing.record_steps(fit_id, loop.marks.names,
                                         loop.kinds, loop.stamp_rows(),
                                         first_epoch=start)
        losses_l = series["loss"]
        accs, f1_ws, f1_ms = (series[k] for k in ("acc", "f1w", "f1m"))
        if verbose:
            for epoch in range(self.epochs):
                if not sum_graph:
                    print(f"Accuracy on validation set = {accs[epoch]}")
                if epoch % 10 == 0:
                    print(f"Epoch: {epoch}, Loss: {losses_l[epoch]:.4f}")
            line = tracing.fit_line(fit_id)
            if line is not None:
                print(line)
        return model, accs, losses_l, f1_ws, f1_ms

    def _step_fn(self, model: torch.nn.Module, graph: DeviceGraph,
                 loss_fn: Callable, activation: str, sum_graph: bool, opt,
                 gen: Optional[torch.Generator]
                 ) -> Callable[[], Tuple[torch.Tensor, ...]]:
        """One epoch of :meth:`fit` as a function of no arguments: the
        validation eval BEFORE the update (modelTrainer.py:53-59), then
        the loss, its backward and Adam. Returns ``(loss,)``, with the
        validation ``(accuracy, weighted F1, macro F1)`` after it for the
        full graph."""

        def step():
            metrics = ()
            if not sum_graph:
                with torch.no_grad():
                    metrics = evaluate(self._logits(model, graph),
                                       graph.x_val, graph.y_val, activation)
            logits = self._logits(model, graph, train=True, gen=gen)
            loss = loss_fn(logits[graph.x_train], graph.y_train)
            mark("loss")
            if opt is not None:
                opt.zero_grad(set_to_none=True)
                loss.backward()
                mark("backward", settle=True)
                opt.step()
                mark("optimizer")
            return (loss, *metrics)

        return step

    # -- checkpoints of a fit ----------------------------------------------

    def _ckpt_path(self, stage: str) -> Optional[str]:
        """Where ``train_original``'s fit of ``stage`` keeps its state;
        None without ``ckpt_dir`` or with ``ckpt_every`` 0 (as the JAX
        package, ``-ckpt_every`` alone checkpoints nothing)."""
        if not (self.ckpt_dir and self.ckpt_every > 0):
            return None
        tag = f"_{self.ckpt_tag}" if self.ckpt_tag != "" else ""
        return os.path.join(self.ckpt_dir, f"fit_{stage}{tag}.npz")

    def _true_order(self, name: str, value: torch.Tensor,
                    graph: DeviceGraph) -> np.ndarray:
        """A parameter (or its Adam moment) as stored: the embedding's
        node axis in true node order, halo phantom rows dropped."""
        if name == "embedding":
            return self._export_embedding(value, graph, graph.edges.num_nodes)
        return value.detach().cpu().numpy()

    def _model_order(self, name: str, value: np.ndarray,
                     graph: DeviceGraph) -> torch.Tensor:
        t = torch.from_numpy(value)
        if name == "embedding":
            return self._pad_embedding(t, graph)
        return t.to(self.device)

    def _save_fit(self, path: str, epoch: int, model: torch.nn.Module,
                  graph: DeviceGraph, trainable: Dict[str, torch.Tensor],
                  opt, gen: Optional[torch.Generator],
                  done: Dict[str, List[float]], rows: List[List[float]]
                  ) -> Dict[str, List[float]]:
        """Write the fit's state after ``epoch`` epochs (``rows``: the
        steps' outputs since ``done``); returns the metric series so
        far."""
        series = _append_series(done, rows)
        arrays = {f"params/{name}": self._true_order(name, p, graph)
                  for name, p in model.named_parameters()}
        for name, p in trainable.items():
            state = opt.state.get(p)
            if state:
                arrays[f"opt/{name}/step"] = state["step"].cpu().numpy()
                for key in ("exp_avg", "exp_avg_sq"):
                    arrays[f"opt/{name}/{key}"] = self._true_order(
                        name, state[key], graph)
        extra = {"series": series}
        if gen is not None:
            arrays["rng/dropout"] = gen.get_state().numpy()
            extra["dropout_device"] = gen.device.type
        save_checkpoint(path, arrays, epoch=epoch, extra=extra)
        return series

    def _restore_fit(self, path: str, model: torch.nn.Module,
                     graph: DeviceGraph, trainable: Dict[str, torch.Tensor],
                     opt, gen: Optional[torch.Generator]
                     ) -> Tuple[int, Dict[str, List[float]]]:
        """Load the state :meth:`_save_fit` wrote into ``model``, ``opt``
        and ``gen``; returns ``(epoch, metric series)``."""
        arrays, meta = load_checkpoint(path)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(self._model_order(name, arrays[f"params/{name}"],
                                          graph))
        if opt is not None:
            state = {}
            for i, (name, p) in enumerate(trainable.items()):
                if f"opt/{name}/step" not in arrays:
                    continue
                state[i] = {
                    "step": torch.tensor(float(arrays[f"opt/{name}/step"]),
                                         dtype=torch.float32),
                    **{key: self._model_order(name, arrays[f"opt/{name}/{key}"],
                                              graph)
                       for key in ("exp_avg", "exp_avg_sq")}}
            opt.load_state_dict({"state": state,
                                 "param_groups": opt.state_dict()["param_groups"]})
        if gen is not None:
            if meta.get("dropout_device") != gen.device.type:
                raise ValueError(
                    f"{path} holds a {meta.get('dropout_device')} dropout "
                    f"generator; this fit draws on {gen.device.type}")
            gen.set_state(torch.from_numpy(arrays["rng/dropout"]))
        print(f"Resumed fit from {path} at epoch {meta['epoch']}")
        return int(meta["epoch"]), meta["series"]

    # -- summary pre-training (modelTrainer.py:76-82) ----------------------

    def train_summaries(self, configs: Dict[str, Any], verbose: bool = True,
                        save_path: Optional[str] = None) -> None:
        """Pre-train the trunk over the summary graphs; with ``save_path``
        write the trunk and the summary embeddings there
        (``utils/checkpoint.py`` ``save_transfer_state``)."""
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
        if save_path:
            save_transfer_state(save_path, (model.rgcn1, model.rgcn2),
                                [sg.embedding for sg in self.data.sumGraphs])

    def load_summaries(self, path: str) -> None:
        """Take the summary pre-training from a ``save_transfer_state``
        file (of either package): each summary graph's embedding and the
        trunk that ``transfer_weights`` copies."""
        trunk, embs = load_transfer_state(path)
        if len(embs) != len(self.data.sumGraphs) or len(trunk) != 2:
            raise ValueError(
                f"{path} holds {len(trunk)} trunk layers and {len(embs)} "
                f"summary embeddings; the dataset has "
                f"{len(self.data.sumGraphs)} summary graphs")
        for sg, emb in zip(self.data.sumGraphs, embs):
            sg.embedding = np.asarray(emb)
        rgcn1, rgcn2 = (model_heads.layer_from_numpy(
            [layer.get(k) for k in ("weight", "root", "bias", "comp")])
            for layer in trunk)
        self.sum_model = model_heads.EmbModel(
            torch.zeros(0, self.emb_dim), rgcn1, rgcn2).to(self.device)

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
        # the embedding the model starts from, in true node order
        embedding = model.embedding.detach().cpu().clone()
        model.embedding = torch.nn.Parameter(self._pad_embedding(
            model.embedding.detach(), dev_graph))
        frozen = set()

        if exp != "baseline" and configs.get("e_trans", False):
            embedding = EMBEDDING_TRICKS[head](og, self.data.sumGraphs,
                                               self.emb_dim, self.gen)
            model.embedding = torch.nn.Parameter(self._pad_embedding(
                embedding.clone(), dev_graph))
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
            frozen=frozen, verbose=verbose,
            ckpt_path=self._ckpt_path(f"{configs['dataset']}_{exp}"))

        test_acc, test_f1_w, test_f1_m = self.evaluate_test(
            model, dev_graph, activation, report=verbose)
        if verbose:
            print("ACC ON TEST SET = ", test_acc)
        return {
            "accuracy": accs, "loss": losses,
            "f1 weighted": f1_ws, "f1 macro": f1_ms,
            "test_acc": test_acc, "test_f1_weighted": test_f1_w,
            "test_f1_macro": test_f1_m, "model": model, "frozen": frozen,
            "embedding": embedding,
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


_SERIES = ("loss", "acc", "f1w", "f1m")


def _append_series(done: Dict[str, List[float]], rows: List[List[float]]
                   ) -> Dict[str, List[float]]:
    """The metric series ``done`` followed by the epochs' rows ``(loss,
    [acc, f1w, f1m])`` of a :class:`StepGraph`'s ``series``."""
    out = {k: list(v) for k, v in done.items()}
    for k, col in zip(_SERIES, zip(*rows)):
        out[k] += list(col)
    return out


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
