"""The port's ``utils/tracing.py`` against the JAX package's, on the CPU.

- ``throughput``: equal to the JAX function on a grid of inputs (the same
  formula and floor, Python floats on both sides).
- ``determinism_check``: true for the port's float32 ``rgcn_conv`` (fused
  and edge mode, the kernels' plain versions) with its gradients, false
  for a draw from the global generator, which advances between runs;
  floats compare as bits (a NaN equals itself, -0.0 differs from 0.0).
- ``trace``: a Chrome trace file in the directory, with the ``annotate``
  region named in it.
"""

import json
import os

import numpy as np
import pytest
import torch

from scaling_rgcn_training_tpu.utils import tracing as jtracing
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    build_rel_edges, init_rgcn_layer, rgcn_conv)
from scaling_rgcn_training_tpu_torch.utils import tracing


@pytest.mark.parametrize("seconds", [0.0, 1e-15, 1e-12, 3.5e-3, 2.0])
@pytest.mark.parametrize("edges,layers", [(0, 2), (4_000_000, 2),
                                          (12_000_000, 1), (7, 3)])
def test_throughput_matches_jax(edges, layers, seconds):
    assert tracing.throughput(edges, layers, seconds) == \
        jtracing.throughput(edges, layers, seconds)


def _conv_and_grads(mode):
    rng = np.random.default_rng(0)
    n, e, slots = 300, 2000, 7
    src, dst, typ = (rng.integers(0, n, e), rng.integers(0, n, e),
                     rng.integers(0, slots, e))
    edges = build_rel_edges(src, dst, typ, n, slots)
    gen = torch.Generator().manual_seed(0)
    layer = init_rgcn_layer(gen, slots, 16, 8)
    x = torch.randn(n, 16, generator=gen, requires_grad=True)

    def fn():
        out = rgcn_conv(x, edges, layer, mode=mode)
        grads = torch.autograd.grad(out.square().sum(),
                                    [x, layer.weight, layer.root])
        return {"out": out.detach(), "grads": list(grads)}
    return fn


@pytest.mark.parametrize("mode", ["fused", "edge"])
def test_determinism_check_true_for_the_conv(mode):
    assert tracing.determinism_check(_conv_and_grads(mode))
    assert tracing.determinism_check(_conv_and_grads(mode), tries=3)


def test_determinism_check_false_for_an_advancing_generator():
    assert not tracing.determinism_check(lambda: torch.rand(16))
    # a seeded generator made inside the function repeats its draws
    assert tracing.determinism_check(
        lambda: torch.rand(16, generator=torch.Generator().manual_seed(3)))


def test_determinism_check_compares_bits_and_structure():
    nan = torch.tensor([float("nan"), 1.0])
    assert tracing.determinism_check(lambda: (nan.clone(), [nan.clone()]))
    zeros = iter([torch.tensor([0.0]), torch.tensor([-0.0])])
    assert not tracing.determinism_check(lambda: next(zeros))
    shapes = iter([torch.zeros(2), torch.zeros(3)])
    assert not tracing.determinism_check(lambda: next(shapes))
    lengths = iter([(1.0,), (1.0, 2.0)])
    assert not tracing.determinism_check(lambda: next(lengths))
    keys = iter([{"a": 1}, {"b": 1}])
    assert not tracing.determinism_check(lambda: next(keys))
    arrays = iter([np.arange(3.0), np.arange(3.0) + 1])
    assert not tracing.determinism_check(lambda: next(arrays))


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    log_dir = tmp_path / "traces"
    with tracing.trace(str(log_dir)) as prof:
        with tracing.annotate("bench_train_step"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert prof.trace_path == str(log_dir / files[0])
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any(ev.get("name") == "bench_train_step" for ev in events)


def test_trace_writes_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError):
        with tracing.trace(str(tmp_path)):
            raise ValueError("inside")
    assert len(os.listdir(tmp_path)) == 1
