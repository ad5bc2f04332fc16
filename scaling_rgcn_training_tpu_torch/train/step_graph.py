"""The train step as one dispatch: a training loop's step captured once as
a CUDA graph and replayed.

Counterpart of the JAX package's ``jax.jit`` over ``lax.scan`` (its
``train/trainer.py`` ``_cached_fit_fn``, ``bench.py``,
``scripts/rehearse_am.py`` and ``scripts/bench_scaling.py``), where a
whole run of steps is one device dispatch. :class:`StepGraph` runs a step
function of no arguments whose tensors are all static (the edges or
``DeviceGraph``, the parameters, the optimizer):

- the first ``warmup`` steps eagerly, on the graph's side stream. They
  are real steps of the run. They build the CUDA libraries
  (``ops/cuda_build.py`` compiles at a kernel's first launch, which must
  never happen inside a capture), make Adam's state, run the kernels'
  one-time host calls and set up cuBLAS. The last of them runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so a host read on the
  step's path raises there, with its traceback, before any capture;
- then one step captured (``torch.cuda.graph``, global capture mode),
  the parameters' grads set to None first so that the backward makes
  them in the graph's private pool;
- then that graph replayed for every remaining step.

Each step's outputs (the loss, and the validation metrics where there are
any) are written on the device into ``series`` ``[steps, outputs]``, row
by row through a device cursor, as the scan stacks its outputs: no step
reads a value back to the host. Beside it, ``stamps`` ``[steps,
MAX_SLOTS]`` (int64) takes the step's device stamps through the same
cursor (``utils/tracing.py`` ``mark``: ``step.start`` and ``step.end``
here, the layers' marks inside the step function), captured with the step
so that every replay stamps its own row; ``marks.names`` names its
columns. Each step runs in a recorder span (``fit.warmup``,
``fit.capture`` then ``fit.step`` for a replay, ``fit.step`` for an eager
step), the wait for the card's queued steps in ``fit.drain`` and the
graph's teardown in ``fit.close``; ``kinds`` says how each step ran
(``"warmup"``, ``"replay"``, ``"eager"``). A replay adds the wrapper
launch counts the capture saw to ``cuda_build.LAUNCHES``, so ``LAUNCHES``
still counts the launches that ran (the capture itself runs nothing and
counts nothing). A dropout generator is registered with the graph, so
its masks advance on every replay as they do eagerly. :meth:`StepGraph.close`
frees the graph and its private pool.

The route (:func:`step_route`): ``"graph"`` where every tensor of the
loop lies on one card in one process (a mesh of virtual shards of one
card included); ``"eager"`` on the CPU, with ``RGCN_EAGER_STEP`` set
(the earlier route, the only way to it on a card), and for a mesh over
several cards, whose capture would need a graph per card with the
cross-card copies inside them. Across processes (``multihost_sim.py``)
each process runs its own loop eagerly: its exchanges block on the host
(gloo, IPC barriers). The eager route runs the same step function and
writes the same series. A capture that fails raises; nothing falls back
to the eager route.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Iterable, Iterator, Optional, Sequence

import torch

from scaling_rgcn_training_tpu_torch.ops.cuda_build import LAUNCHES
from scaling_rgcn_training_tpu_torch.utils import tracing
from scaling_rgcn_training_tpu_torch.utils.tracing import mark, span

EAGER_ENV = "RGCN_EAGER_STEP"
# eager steps before the capture (at least 1: the first builds the
# kernels, which no capture may do)
WARMUP = 2


def eager_requested() -> bool:
    """``RGCN_EAGER_STEP`` set (non-empty): the eager route on a card."""
    return bool(os.environ.get(EAGER_ENV))


def step_route(devices: Sequence) -> str:
    """``"graph"`` or ``"eager"`` for a loop whose tensors lie on
    ``devices``, the devices of this process (see the module)."""
    devs = set()
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.add(d)
    if {d.type for d in devs} != {"cuda"} or len(devs) != 1 \
            or eager_requested():
        return "eager"
    return "graph"


def describe(route: str) -> str:
    """The route with the value of ``RGCN_EAGER_STEP``, for logs."""
    return f"{route} ({EAGER_ENV}={os.environ.get(EAGER_ENV)!r})"


class CudaStepGraph:
    """The card's side of a :class:`StepGraph` on ``device``: a side stream
    for the warm-up and the capture, and one ``torch.cuda.CUDAGraph``
    with ``generators`` registered."""

    def __init__(self, device, generators: Iterable[torch.Generator] = ()):
        self.device = torch.device(device)
        with torch.cuda.device(self.device):
            # from the high-priority pool: PyTorch hands out its pooled
            # streams round robin, 32 a priority, so a default-priority
            # stream made here could be the card's halo exchange stream
            # (parallel/ring_halo.py exchange_stream), which the step forks
            self.stream = torch.cuda.Stream(priority=-1)
            self.graph = torch.cuda.CUDAGraph()
            for gen in generators:
                self.graph.register_generator_state(gen)

    @contextlib.contextmanager
    def warmup(self, check: bool = False) -> Iterator[None]:
        """An eager step on the side stream, forked from and joined back
        to the current stream; ``check``: under the sync debug mode
        ``"error"`` (a host read raises)."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                if check:
                    torch.cuda.set_sync_debug_mode("error")
                yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            current.wait_stream(self.stream)

    def capture(self, body: Callable[[], None]) -> None:
        with torch.cuda.device(self.device), torch.cuda.graph(
                self.graph, stream=self.stream, capture_error_mode="global"):
            body()

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()

    def close(self) -> None:
        """Free the graph and its pool, and the cuBLAS workspaces PyTorch
        keeps a stream: this graph's side stream is not used again, and its
        workspace would keep its cached segment reserved (0.45 GiB a fit of
        the featureless basis model, H100 80GB HBM3)."""
        self.graph.reset()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        torch.cuda.empty_cache()


class StepGraph:
    """``steps`` steps of ``step`` (a function of no arguments returning
    ``outputs`` scalar tensors): eagerly with ``graph`` None, else the
    ``WARMUP`` warm-up steps, the capture and the replays on ``graph``
    (:class:`CudaStepGraph`, or a stand-in with its methods). ``params``:
    the tensors whose grads are set to None before the capture (and after
    the last replay, so the private pool can go). ``series``: each step's
    outputs, on ``device``; ``stamps``: each step's marks (``marks``).
    A context manager: leaving it closes."""

    def __init__(self, step: Callable[[], Sequence[torch.Tensor]], steps: int,
                 outputs: int, device, graph=None,
                 params: Iterable[torch.Tensor] = ()):
        self.step = step
        self.steps = steps
        self.graph = graph
        self.params = list(params)
        self.warmup = min(WARMUP, steps)
        self.series = torch.zeros((steps, outputs), dtype=torch.float32,
                                  device=device)
        self._cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.stamps = torch.zeros((steps, tracing.MAX_SLOTS),
                                  dtype=torch.int64, device=device)
        self.marks = tracing.StepMarks(self.stamps, self._cursor)
        self.kinds: list = []
        self.done = 0
        # the wrapper launches of one captured step
        self.captured: Optional[dict] = None

    def _body(self) -> None:
        with self.marks.step():
            mark("step.start")
            values = torch.stack([v.detach().float().reshape(())
                                  for v in self.step()])
            self.series.index_copy_(0, self._cursor, values[None])
            mark("step.end")
            self._cursor += 1

    def run(self) -> None:
        """The next step."""
        if self.done >= self.steps:
            raise RuntimeError(f"all {self.steps} steps have run")
        if self.graph is None:
            with span("fit.step"):
                self._body()
            self.kinds.append("eager")
        elif self.done < self.warmup:
            with span("fit.warmup"), \
                    self.graph.warmup(check=self.done == self.warmup - 1):
                self._body()
            self.kinds.append("warmup")
        else:
            if self.captured is None:
                with span("fit.capture"):
                    self._capture()
            with span("fit.step"):
                self.graph.replay()
            for name, n in self.captured.items():
                LAUNCHES[name] += n
            self.kinds.append("replay")
        self.done += 1

    def _capture(self) -> None:
        for p in self.params:
            p.grad = None
        before = dict(LAUNCHES)
        try:
            self.graph.capture(self._body)
            self.captured = {k: v - before[k] for k, v in LAUNCHES.items()
                             if v != before[k]}
        finally:
            LAUNCHES.update(before)

    def rows(self, lo: int, hi: int) -> list:
        """Steps ``lo .. hi - 1``'s outputs on the host (a host read)."""
        return self.series[lo:hi].tolist()

    def drain(self) -> None:
        """Wait for the card to finish the steps queued so far (in the
        recorder's ``fit.drain`` span): their own time, kept out of the
        readback that follows."""
        if self.series.is_cuda:
            with span("fit.drain"):
                torch.cuda.current_stream(self.series.device).synchronize()

    def stamp_rows(self) -> list:
        """The steps run so far: their stamps in ``marks.names``' slots, on
        the host (after :meth:`rows`, which waits for the card, a copy
        that waits for nothing)."""
        return self.stamps[:self.done, :len(self.marks.names)].tolist()

    def close(self) -> None:
        if self.graph is not None:
            with span("fit.close"):
                if self.captured is not None:
                    for p in self.params:
                        p.grad = None
                self.graph.close()
                self.graph = None

    def __enter__(self) -> "StepGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
