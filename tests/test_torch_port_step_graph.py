"""The train step as one dispatch (``train/step_graph.py``) on the CPU.

- ``Trainer.fit``'s step function, run eagerly, against the loop it
  replaced (written out here as ``_parent_fit``), bit for bit: the
  summation, MLP and attention heads (dropout on), fused and edge mode,
  and the halo (each exchange) and edge partitions on 4 virtual CPU
  shards; and through the graph route's bookkeeping against the JAX
  package's ``fit`` (loss series rtol 1e-4 and accuracies within one
  validation row, as ``test_torch_port_train.py``).
- The step reads nothing back to the host: it runs under a
  ``TorchDispatchMode`` that fails on ``aten._local_scalar_dense``,
  ``aten.item`` and ``aten.nonzero`` (Adam's step count on the CPU
  excepted: on a card Adam is ``capturable`` and keeps it there).
- The warm-up, capture and replay bookkeeping with a stand-in graph: its
  capture runs the step with every write to a tensor dropped (a capture
  records and runs nothing) and its generators' states put back, its
  replay runs the step with the launch counts it adds dropped (a replay
  runs the kernels, not the Python wrappers). The series, ``LAUNCHES``
  per step, ``epochs <= W`` (no capture), a resume mid-run, and
  ``on_epoch`` and checkpoint cadence.
- ``make_optimizer`` is ``capturable`` only on CUDA; the route rule.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from scaling_rgcn_training_tpu.graphs.device import build_device_graph as j_build
from scaling_rgcn_training_tpu.models import heads as jheads
from scaling_rgcn_training_tpu.train import losses as jlosses
from scaling_rgcn_training_tpu.train.trainer import Trainer as JTrainer
from scaling_rgcn_training_tpu_torch import rehearse_am as ra
from scaling_rgcn_training_tpu_torch.graphs.device import (
    DeviceGraph, build_device_graph as t_build)
from scaling_rgcn_training_tpu_torch.models.heads import (
    HEADS, emb_model_from_numpy)
from scaling_rgcn_training_tpu_torch.ops import cuda_build, rgcn_conv
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
from scaling_rgcn_training_tpu_torch.parallel import halo as hp
from scaling_rgcn_training_tpu_torch.parallel import spmd
from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh
from scaling_rgcn_training_tpu_torch.train import losses as tlosses
from scaling_rgcn_training_tpu_torch.train import step_graph as sg
from scaling_rgcn_training_tpu_torch.train import trainer as trainer_mod
from scaling_rgcn_training_tpu_torch.train.metrics import evaluate
from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer
from scaling_rgcn_training_tpu_torch.train.trainer import Trainer

N, E, SLOTS, EMB, HL, C = 400, 3000, 7, 16, 8, 4
EXCHANGES = {"library": None, "#6": "1", "#7": "fused"}


def _splits(rng, n=N, c=C):
    labelled = rng.choice(n, 120, replace=False)
    y = torch.eye(c)[torch.as_tensor(rng.integers(0, c, 120))]
    return dict(x_train=torch.as_tensor(labelled[:80]), y_train=y[:80],
                x_val=torch.as_tensor(labelled[80:]), y_val=y[80:])


def _setup(config, head="summation", epochs=5, seed=0):
    """``(trainer, model, graph)`` on the CPU: ``config`` ``fused``,
    ``edge``, ``aggr-attention``, ``halo-library``, ``halo-#6``,
    ``halo-#7`` or ``edge-partition`` (4 virtual shards)."""
    rng = np.random.default_rng(5)
    src, dst = (rng.integers(0, N, E).astype(np.int32) for _ in range(2))
    typ = rng.integers(0, SLOTS, E).astype(np.int32)
    splits = _splits(rng)
    kw = {}
    if config.startswith("halo") or config == "edge-partition":
        mesh = make_mesh(devices=("cpu",) * 4)
        if config == "edge-partition":
            edges = spmd.device_put_sharded_edges(spmd.shard_rel_edges(
                src, dst, typ, N, SLOTS, 4), mesh)
            kw = dict(mesh=mesh, partition="edge", backend="pallas")
        else:
            edges = hp.device_put_halo_edges(hp.halo_partition_edges(
                src, dst, typ, N, SLOTS, 4), mesh)
            kw = dict(mesh=mesh, partition="halo")
    else:
        edges = build_rel_edges(src, dst, typ, N, SLOTS, device="cpu",
                                span=config == "fused")
        if config != "fused":
            kw = dict(backend="pallas")
        if config == "aggr-attention":
            kw["aggr"] = "attention"
    trainer = Trainer(None, HL, epochs, EMB, lr=0.01, weight_d=5e-5,
                      seed=seed, device="cpu", **kw)
    model = HEADS[head](trainer.gen, SLOTS, HL, C, N, EMB, num_sums=2,
                        device="cpu")
    if head != "summation":
        shape = (N, 2 * EMB) if head == "mlp" else (2, N, EMB)
        model.embedding = torch.nn.Parameter(
            torch.rand(shape, generator=trainer.gen))
    return trainer, model, DeviceGraph(edges=edges, **splits)


def _frozen(head):
    return ("embedding",) if head != "summation" else ()


def _parent_fit(trainer, model, graph, loss_fn, activation, frozen):
    """The epoch loop ``Trainer.fit`` ran before the step function (no
    checkpoints): the validation eval, the loss, its backward and Adam,
    each epoch's tensors stacked at the end."""
    frozen = set(frozen)
    trainable = []
    for name, p in model.named_parameters():
        train = name.split(".")[0] not in frozen
        p.requires_grad_(train)
        if train:
            trainable.append(p)
    opt = make_optimizer(trainable, trainer.lr, trainer.weight_d)
    gen = trainer._dropout_generator(model)
    losses, metrics = [], []
    for _ in range(trainer.epochs):
        with torch.no_grad():
            logits = trainer._logits(model, graph)
            metrics.append(torch.stack(evaluate(
                logits, graph.x_val, graph.y_val, activation)))
        logits = trainer._logits(model, graph, train=True, gen=gen)
        loss = loss_fn(logits[graph.x_train], graph.y_train)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    accs, f1w, f1m = (list(c) for c in zip(*torch.stack(metrics).tolist()))
    return torch.stack(losses).tolist(), accs, f1w, f1m


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def _bits_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("config,head", [
    ("fused", "summation"), ("fused", "mlp"), ("fused", "attention"),
    ("edge", "summation"), ("edge", "mlp"), ("edge", "attention"),
    ("aggr-attention", "summation"), ("halo-library", "summation"),
    ("halo-#6", "summation"), ("halo-#7", "summation"),
    ("edge-partition", "summation")])
def test_step_function_matches_parent_loop(config, head, monkeypatch):
    """The refactored ``fit`` (its step function, run eagerly on the CPU)
    against the loop it replaced, from one seed: the loss and validation
    series and every parameter bit for bit."""
    exchange = EXCHANGES.get(config.split("-", 1)[-1])
    if exchange is None:
        monkeypatch.delenv(hp.EXCHANGE_ENV, raising=False)
    else:
        monkeypatch.setenv(hp.EXCHANGE_ENV, exchange)
    loss_fn, act = tlosses.get_loss("SYNTH", sum_model=False)
    trainer, model, graph = _setup(config, head)
    assert trainer.step_route() == "eager"
    ref = _parent_fit(trainer, model, graph, loss_fn, act, _frozen(head))
    ref_params = _params(model)
    trainer, model, graph = _setup(config, head)
    _, accs, losses, f1w, f1m = trainer.fit(
        model, graph, loss_fn, act, sum_graph=False, frozen=_frozen(head),
        verbose=False)
    assert (losses, accs, f1w, f1m) == ref
    assert _bits_equal(_params(model), ref_params)


# the kernels' plain versions, which a wrapper takes only for tensors on
# the CPU (on a card it launches the kernel): (module, name)
PLAIN_VERSIONS = (
    ("scaling_rgcn_training_tpu_torch.ops.span_kernels", "span_forward_plain"),
    ("scaling_rgcn_training_tpu_torch.ops.span_kernels", "span_backward_plain"),
    ("scaling_rgcn_training_tpu_torch.ops.segment_kernels",
     "sorted_segment_sum_plain"),
    ("scaling_rgcn_training_tpu_torch.ops.grouped_kernels", "gmm_plain"),
    ("scaling_rgcn_training_tpu_torch.ops.grouped_kernels", "gmm_drhs_plain"),
    ("scaling_rgcn_training_tpu_torch.parallel.ring_halo",
     "halo_exchange_plain"),
    ("scaling_rgcn_training_tpu_torch.parallel.fused_halo",
     "fused_halo_aggregate_plain"))


class _HostReadGuard(TorchDispatchMode):
    """Fails on a value read back to the host, except inside the kernels'
    plain versions (:meth:`exempt_plain_versions`: on a card the kernels
    run there) and on ``allowed`` (the data pointers of tensors whose
    reads are the CPU's own)."""

    READS = {"aten._local_scalar_dense.default", "aten.item.default",
             "aten.nonzero.default", "aten.nonzero.out"}

    def __init__(self, allowed=()):
        super().__init__()
        self.allowed = set(allowed)
        self.calls = 0
        self.plain = 0

    def exempt_plain_versions(self, monkeypatch):
        import importlib

        for module, name in PLAIN_VERSIONS:
            mod = importlib.import_module(module)
            monkeypatch.setattr(mod, name, self._exempt(getattr(mod, name)))
        return self

    def _exempt(self, fn):
        def run(*args, **kwargs):
            self.plain += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.plain -= 1
        return run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        if str(func) in self.READS and not self.plain and not (
                args and isinstance(args[0], torch.Tensor)
                and args[0].data_ptr() in self.allowed):
            raise AssertionError(f"the step reads a value back: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("config,head", [
    ("fused", "summation"), ("fused", "mlp"), ("fused", "attention"),
    ("edge", "summation"), ("aggr-attention", "summation"),
    ("halo-library", "summation"), ("halo-#6", "summation"),
    ("halo-#7", "summation"), ("edge-partition", "summation")])
def test_step_reads_nothing_back(config, head, monkeypatch):
    """``Trainer.fit``'s step function under the host-read guard (its
    second step: Adam's state is made in the first)."""
    exchange = EXCHANGES.get(config.split("-", 1)[-1])
    if exchange is not None:
        monkeypatch.setenv(hp.EXCHANGE_ENV, exchange)
    loss_fn, act = tlosses.get_loss("AIFB", sum_model=False)
    trainer, model, graph = _setup(config, head)
    trainable = [p for name, p in model.named_parameters()
                 if name.split(".")[0] not in _frozen(head)]
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] not in _frozen(head))
    opt = make_optimizer(trainable, trainer.lr, trainer.weight_d)
    step = trainer._step_fn(model, graph, loss_fn, act, False, opt,
                            trainer._dropout_generator(model))
    step()
    guard = _HostReadGuard([s["step"].data_ptr() for s in opt.state.values()])
    with guard.exempt_plain_versions(monkeypatch):
        out = step()
    assert len(out) == 4 and guard.calls > 100


def test_rehearse_step_reads_nothing_back(monkeypatch):
    """``rehearse_am.train``'s step (also ``bench``'s) under the guard,
    from its second step on (Adam's state is made in the first)."""
    k = {"nodes": 600, "edges": 5000, "rels": 3, "dim": 8, "hidden": 4,
         "inner": 3, "calls": 0, "plan_cache": None}
    dev = torch.device("cpu")
    edges, rows, targets, slots, _ = ra.build_edges(k, dev)
    opts, guards = [], []
    real_make, real_run = make_optimizer, sg.StepGraph.run

    def run(self):
        if self.done == 0:
            return real_run(self)
        guards.append(_HostReadGuard(
            [s["step"].data_ptr() for s in opts[0].state.values()]
        ).exempt_plain_versions(monkeypatch))
        with guards[-1]:
            return real_run(self)

    monkeypatch.setattr("scaling_rgcn_training_tpu_torch.train.optim."
                        "make_optimizer",
                        lambda *a, **kw: opts.append(real_make(*a, **kw))
                        or opts[-1])
    monkeypatch.setattr(sg.StepGraph, "run", run)
    res = ra.run(k, dev, edges, rows, targets, slots)
    assert res["step"] == "eager" and len(res["losses"]) == 3
    assert len(guards) == 2 and all(g.calls > 50 for g in guards)


# -- the graph route's bookkeeping, with a stand-in graph -----------------


class _NoWrites(TorchDispatchMode):
    """Every op runs, but an op's writes go to copies of the tensors it
    would write: the tensors keep their values (a capture runs nothing)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        args = list(args)
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            copy = lambda v: [t.clone() for t in v] if isinstance(
                v, (list, tuple)) else v.clone()
            if arg.name in kwargs:
                kwargs[arg.name] = copy(kwargs[arg.name])
            elif i < len(args):
                args[i] = copy(args[i])
        return func(*args, **kwargs)


class StandInGraph:
    """A :class:`step_graph.CudaStepGraph` on the CPU: the capture runs
    the step under :class:`_NoWrites` and puts the generators' states
    back; a replay runs the step and drops the launch counts the wrappers
    add (the runner adds the captured ones). ``log``: what ran."""

    made = []

    def __init__(self, device=None, generators=()):
        self.generators = list(generators)
        self.body = None
        self.log = []
        StandInGraph.made.append(self)

    @contextlib.contextmanager
    def warmup(self, check=False):
        self.log.append("warmup")
        yield

    def capture(self, body):
        states = [g.get_state() for g in self.generators]
        with _NoWrites():
            body()
        for g, state in zip(self.generators, states):
            g.set_state(state)
        self.body = body
        self.log.append("capture")

    def replay(self):
        before = dict(cuda_build.LAUNCHES)
        self.body()
        cuda_build.LAUNCHES.update(before)
        self.log.append("replay")

    def close(self):
        self.log.append("close")


@pytest.fixture
def graph_route(monkeypatch):
    """``Trainer.fit`` and ``rehearse_am.train`` take the graph route on
    the CPU through :class:`StandInGraph`; #1 counts its (plain) calls as
    launches, as its wrapper counts launches on the card."""
    StandInGraph.made = []
    monkeypatch.setattr(trainer_mod, "step_route", lambda devices: "graph")
    monkeypatch.setattr(trainer_mod, "CudaStepGraph", StandInGraph)
    monkeypatch.setattr(sg, "step_route", lambda devices: "graph")
    monkeypatch.setattr(sg, "CudaStepGraph", StandInGraph)
    real = rgcn_conv.span_forward

    def counted(*a, **kw):
        cuda_build.LAUNCHES["span_forward"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(rgcn_conv, "span_forward", counted)
    cuda_build.reset_launch_counts()
    yield StandInGraph.made
    cuda_build.reset_launch_counts()


def _fit(config, head, epochs, graph_route=None, **fit_kw):
    loss_fn, act = tlosses.get_loss("SYNTH", sum_model=False)
    trainer, model, graph = _setup(config, head, epochs)
    counts = []
    on_epoch = fit_kw.pop("on_epoch", None)

    def hook(epoch):
        counts.append(dict(cuda_build.LAUNCHES))
        if on_epoch is not None:
            on_epoch(epoch)

    start = dict(cuda_build.LAUNCHES)
    out = trainer.fit(model, graph, loss_fn, act, sum_graph=False,
                      frozen=_frozen(head), verbose=False, on_epoch=hook,
                      **fit_kw)
    per_step = [b["span_forward"] - a["span_forward"] for a, b in
                zip([start] + counts, counts)]
    return out[1:], _params(model), per_step


@pytest.mark.parametrize("config,head", [("fused", "summation"),
                                         ("fused", "attention"),
                                         ("halo-#7", "summation")])
def test_stand_in_graph_bookkeeping(config, head, graph_route, monkeypatch):
    """The graph route (warm-up, capture, replays) against the eager one:
    the same series and parameters bit for bit (the attention head's
    dropout masks advance on every replay), ``LAUNCHES`` the same each
    step (4 calls of #1 a step: 2 layers, validation and training), and
    the stand-in's log: 2 warm-ups, one capture, 6 replays, close."""
    if config == "halo-#7":
        monkeypatch.setenv(hp.EXCHANGE_ENV, "fused")
    graphed = _fit(config, head, 8)
    assert graph_route[-1].log == ["warmup"] * sg.WARMUP + ["capture"] + \
        ["replay"] * (8 - sg.WARMUP) + ["close"]
    if head == "attention":
        assert len(graph_route[-1].generators) == 1
    monkeypatch.setattr(trainer_mod, "step_route", lambda devices: "eager")
    eager = _fit(config, head, 8)
    assert graphed[0] == eager[0] and _bits_equal(graphed[1], eager[1])
    want = 0 if config == "halo-#7" else 4
    assert graphed[2] == eager[2] == [want] * 8


def test_stand_in_graph_short_fit_never_captures(graph_route):
    """``epochs <= W``: every step is a warm-up step; no capture."""
    _fit("fused", "summation", sg.WARMUP)
    assert graph_route[-1].log == ["warmup"] * sg.WARMUP + ["close"]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("head", ["summation", "attention"])
def test_stand_in_graph_resume_and_cadence(head, graph_route, tmp_path,
                                           monkeypatch):
    """A graphed fit of 9 epochs that checkpoints every 3, stopped by
    ``on_epoch`` after epoch 4, then resumed: checkpoints written after
    epochs 3 (stopped run), 6 and 9 (resumed run), ``on_epoch`` called for
    every epoch it ran, the resumed run warmed up and captured again, and
    the unbroken eager run's series and parameters bit for bit."""
    path = str(tmp_path / "fit.npz")
    saved = []
    real_save = Trainer._save_fit

    def save(self, path_, epoch, *a, **kw):
        saved.append(epoch)
        return real_save(self, path_, epoch, *a, **kw)

    monkeypatch.setattr(Trainer, "_save_fit", save)
    seen = []

    def stop(epoch):
        seen.append(epoch)
        if epoch == 4:
            raise _Stop

    loss_fn, act = tlosses.get_loss("SYNTH", sum_model=False)

    def run(seed, hook):
        trainer, model, graph = _setup("fused", head, 9, seed=seed)
        trainer.ckpt_every = 3
        out = trainer.fit(model, graph, loss_fn, act, sum_graph=False,
                          frozen=_frozen(head), verbose=False,
                          on_epoch=hook, ckpt_path=path)
        return out[1:], _params(model)

    with pytest.raises(_Stop):
        run(0, stop)
    assert saved == [3] and seen == [0, 1, 2, 3, 4]
    assert graph_route[-1].log[-1] == "close"
    # another seed: every value comes from the checkpoint
    resumed = run(1, seen.append)
    assert saved == [3, 6, 9] and seen[5:] == [3, 4, 5, 6, 7, 8]
    assert graph_route[-1].log == ["warmup"] * sg.WARMUP + ["capture"] + \
        ["replay"] * (6 - sg.WARMUP) + ["close"]
    monkeypatch.setattr(trainer_mod, "step_route", lambda devices: "eager")
    trainer, model, graph = _setup("fused", head, 9)
    unbroken = trainer.fit(model, graph, loss_fn, act, sum_graph=False,
                           frozen=_frozen(head), verbose=False)
    assert resumed[0] == unbroken[1:]
    assert _bits_equal(resumed[1], _params(model))


def test_stand_in_graph_rehearse_train(graph_route, monkeypatch):
    """``rehearse_am.train`` (``bench``'s loop) through the stand-in: the
    eager run's losses bit for bit, 2 launches of #1 counted every step
    (warm-up and replays), ``step`` named."""
    k = {"nodes": 600, "edges": 5000, "rels": 3, "dim": 8, "hidden": 4,
         "inner": 3, "calls": 2, "plan_cache": None}
    dev = torch.device("cpu")
    edges, rows, targets, slots, _ = ra.build_edges(k, dev)
    graphed = ra.run(k, dev, edges, rows, targets, slots)
    assert graph_route[-1].log.count("replay") == 9 - sg.WARMUP
    monkeypatch.setattr(sg, "step_route", lambda devices: "eager")
    eager = ra.run(k, dev, edges, rows, targets, slots)
    assert (graphed["step"], eager["step"]) == ("graph", "eager")
    assert graphed["losses"] == eager["losses"]
    assert [st["span_forward"] for st in graphed["launches"]] == \
        [st["span_forward"] for st in eager["launches"]] == [2] * 9


def test_stand_in_graph_series_and_launches():
    """:class:`StepGraph` alone: each step's outputs in its row of
    ``series``; ``LAUNCHES`` per step the same in warm-up and replays
    while the capture adds nothing; a step past the last raises."""
    cuda_build.reset_launch_counts()
    state = torch.zeros(())

    def step():
        cuda_build.LAUNCHES["segment_sum"] += 3
        state.add_(1.0)
        return (state * 2.0, state + 0.5)

    stand_in = StandInGraph()
    loop = sg.StepGraph(step, 5, 2, "cpu", stand_in)
    per = []
    with loop:
        for _ in range(5):
            before = cuda_build.LAUNCHES["segment_sum"]
            loop.run()
            per.append(cuda_build.LAUNCHES["segment_sum"] - before)
        with pytest.raises(RuntimeError):
            loop.run()
    assert loop.rows(0, 5) == [[2.0 * i, i + 0.5] for i in range(1, 6)]
    assert per == [3] * 5 and loop.captured == {"segment_sum": 3}
    assert stand_in.log == ["warmup"] * sg.WARMUP + ["capture"] + \
        ["replay"] * (5 - sg.WARMUP) + ["close"]
    cuda_build.reset_launch_counts()


def test_fit_through_graph_route_matches_jax(graph_route):
    """The graph route's bookkeeping (stand-in) against the JAX ``fit``
    from the same parameters: loss series rtol 1e-4, accuracies within
    one validation row."""
    rng = np.random.default_rng(0)
    n, e, r, c = 200, 1500, 3, 4
    labelled = rng.choice(n, 90, replace=False)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, 90)]
    g = SimpleNamespace(
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_type=rng.integers(0, 2 * r, e).astype(np.int32),
        num_nodes=n, num_relation_slots=2 * r + 1, num_classes=c,
        x_train=labelled[:60].astype(np.int32), y_train=y[:60],
        x_val=labelled[60:].astype(np.int32), y_val=y[60:],
        x_test=None, y_test=None)
    emb, hl, epochs = 12, 8, 6
    params = jheads.init_emb_model(jax.random.key(3), g.num_relation_slots,
                                   hl, c, n, emb)
    jt = JTrainer(None, hl, epochs, emb, 0.01, 5e-5, backend="gather")
    jloss, act = jlosses.get_loss("SYNTH", sum_model=False)
    _, jaccs, jl, _, _ = jt.fit(params, jheads.apply_emb_model, j_build(g),
                                jloss, act, sum_graph=False, verbose=False)
    model = emb_model_from_numpy(np.asarray(params.embedding),
                                 list(params.rgcn1), list(params.rgcn2))
    tt = Trainer(None, hl, epochs, emb, 0.01, 5e-5, device="cpu")
    tloss, tact = tlosses.get_loss("SYNTH", sum_model=False)
    _, taccs, tl, _, _ = tt.fit(model, t_build(g, "cpu"), tloss, tact,
                                sum_graph=False, verbose=False)
    assert graph_route[-1].log.count("replay") == epochs - sg.WARMUP
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(taccs, jaccs, rtol=0,
                               atol=1.0 / len(g.x_val) + 1e-7)


# -- the optimizer and the route rule -------------------------------------


def test_make_optimizer_capturable_only_on_cuda():
    """CPU parameters: not capturable (PyTorch refuses it there); the rule
    reads the parameters' device."""
    p = torch.nn.Parameter(torch.zeros(3))
    assert make_optimizer([p], 0.01).defaults["capturable"] is False
    assert make_optimizer([p], 0.01, 5e-5).param_groups[0][
        "capturable"] is False


def test_step_route_rule(monkeypatch):
    monkeypatch.delenv(sg.EAGER_ENV, raising=False)
    assert sg.step_route(["cpu"]) == "eager"
    assert sg.step_route(["cpu"] * 4) == "eager"
    assert sg.step_route(["cuda:0"]) == "graph"
    assert sg.step_route([torch.device("cuda", 1)] * 4) == "graph"
    assert sg.step_route(["cuda:0", "cuda:1"]) == "eager"
    monkeypatch.setenv(sg.EAGER_ENV, "1")
    assert sg.step_route(["cuda:0"]) == "eager"
    assert sg.describe("eager") == f"eager ({sg.EAGER_ENV}='1')"


def test_kernels_inside_counts_by_timestamp():
    """``tracing.kernels_inside`` on a hand-made trace of a replayed
    graph: the windows are the named exchange kernels on whatever stream,
    the compute kernels that meet them are counted once each, the rest
    (outside, or not compute) not."""
    from scaling_rgcn_training_tpu_torch.utils import tracing

    def ev(name, start, end, stream):
        return {"name": f"void {name}<float>(int)", "cat": "kernel",
                "device": 0, "stream": stream, "start": float(start),
                "end": float(end), "launch": None}

    events = sorted([
        ev("halo_pull_kernel", 10, 20, 7), ev("halo_pull_kernel", 50, 60, 9),
        ev("span_msg_kernel", 12, 30, 11), ev("span_msg_kernel", 0, 10, 11),
        ev("segment_sum_kernel", 55, 70, 12), ev("elementwise", 15, 18, 13),
        ev("span_bwd_chunk_kernel", 61, 80, 7)], key=lambda e: e["start"])
    got = tracing.kernels_inside(
        events, lambda n: n == "halo_pull_kernel",
        lambda n: n.startswith(("span_", "segment_sum")))
    assert got["inside"] == 2
    assert got["kernels"] == {"span_msg_kernel": 1, "segment_sum_kernel": 1}
    assert got["window_ms"] == pytest.approx(0.020)
    assert got["overlap_ms"] == pytest.approx(0.013)
    assert got["busy_ms"] == pytest.approx(0.060)
    assert got["streams"] == 5
