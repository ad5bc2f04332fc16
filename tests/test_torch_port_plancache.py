"""The port's plan cache (``utils/plancache.py``): cached plans equal fresh
builds for every plan kind, every input of the key misses, unreadable
entries rebuild, and the key does not depend on the process."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scaling_rgcn_training_tpu_torch.graphs.dataset import Dataset
from scaling_rgcn_training_tpu_torch.graphs.device import build_device_graph
from scaling_rgcn_training_tpu_torch.graphs.synthetic import ensure_synthetic_dataset
from scaling_rgcn_training_tpu_torch.ops import span_kernels
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
from scaling_rgcn_training_tpu_torch.parallel.halo import halo_partition_edges
from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh
from scaling_rgcn_training_tpu_torch.parallel.spmd import shard_rel_edges
from scaling_rgcn_training_tpu_torch.utils import plancache, plantree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, E, SLOTS = 300, 2500, 7


def _edges(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N, E).astype(np.int32),
            rng.integers(0, N, E).astype(np.int32),
            rng.integers(0, SLOTS - 1, E).astype(np.int32))


BUILDERS = {
    "reledges": lambda e, d: build_rel_edges(*e, N, SLOTS, cache_dir=d),
    "reledges-nospan": lambda e, d: build_rel_edges(*e, N, SLOTS, span=False,
                                                   cache_dir=d),
    "haloedges": lambda e, d: halo_partition_edges(*e, N, SLOTS, 3,
                                                   cache_dir=d),
    "shardededges": lambda e, d: shard_rel_edges(*e, N, SLOTS, 2,
                                                 cache_dir=d),
}


def assert_same_plan(a, b, path="plan"):
    """Field by field: the same dataclass, tensors and arrays of the same
    dtype, shape and values, the same ints and tuples."""
    assert type(a) is type(b), path
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same_plan(getattr(a, f.name), getattr(b, f.name),
                             f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_plan(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_cached_plan_equals_fresh_build(tmp_path, kind):
    edges = _edges()
    fresh = BUILDERS[kind](edges, None)
    cold = BUILDERS[kind](edges, str(tmp_path))
    (entry,) = os.listdir(tmp_path)
    assert entry.startswith(kind.split("-")[0] + "-") and entry.endswith(".npz")
    warm = BUILDERS[kind](edges, str(tmp_path))
    assert os.listdir(tmp_path) == [entry]
    assert_same_plan(cold, fresh)
    assert_same_plan(warm, fresh)
    # tensors the build shares (RelEdges and its span plan) stay shared
    if kind == "reledges":
        assert warm.src is warm.span.rel_src
        assert warm.dst_rowptr is warm.span.fwd_rowptr


def test_cached_partition_on_a_mesh_equals_fresh(tmp_path):
    """``build_device_graph(plan_cache=...)`` over a halo partition with a
    locality reorder: the warm plan on the mesh equals the fresh one."""
    ds = ensure_synthetic_dataset(str(tmp_path / "g"), num_entities=200,
                                  seed=3)
    data = Dataset(os.path.join(ds, "SYNTH_complete.nt"),
                   os.path.join(ds, "attr", "sum"),
                   os.path.join(ds, "attr", "map")).init_dataset(verbose=False)
    mesh = make_mesh(devices=("cpu",) * 2)
    kw = dict(mesh=mesh, partition="halo", reorder=True)
    fresh = build_device_graph(data.orgGraph, "cpu", **kw)
    for _ in range(2):
        cached = build_device_graph(data.orgGraph, "cpu",
                                    plan_cache=str(tmp_path / "pc"), **kw)
        assert_same_plan(cached.edges, fresh.edges)
        np.testing.assert_array_equal(cached.node_perm, fresh.node_perm)
    assert len(os.listdir(tmp_path / "pc")) == 1


@pytest.mark.parametrize("change", ["arrays", "statics", "version", "chunk"])
def test_every_input_of_the_key_misses(tmp_path, monkeypatch, change):
    edges = _edges()
    build = BUILDERS["reledges"]
    build(edges, str(tmp_path))
    if change == "arrays":
        edges = (edges[0], edges[1], np.roll(edges[2], 1))
    elif change == "version":
        monkeypatch.setattr(plancache, "_VERSION", plancache._VERSION + 1)
    elif change == "chunk":
        monkeypatch.setattr(span_kernels, "DW_CHUNK", span_kernels.DW_CHUNK // 2)
    if change == "statics":
        plan = BUILDERS["reledges-nospan"](edges, str(tmp_path))
        assert plan.span is None
    else:
        plan = build(edges, str(tmp_path))
        assert_same_plan(plan, build(edges, None))
    assert len(os.listdir(tmp_path)) == 2


def test_truncated_entry_rebuilds_with_a_warning(tmp_path):
    edges = _edges()
    fresh = BUILDERS["haloedges"](edges, str(tmp_path))
    (entry,) = os.listdir(tmp_path)
    path = tmp_path / entry
    whole = path.read_bytes()
    path.write_bytes(whole[:len(whole) // 2])
    with pytest.warns(UserWarning, match="unreadable plan cache entry"):
        plan = BUILDERS["haloedges"](edges, str(tmp_path))
    assert_same_plan(plan, fresh)
    assert path.read_bytes() == whole
    assert os.listdir(tmp_path) == [entry]


def test_entry_naming_another_class_is_not_loaded(tmp_path):
    """Loading rebuilds only the port's plan classes: an entry whose tree
    names any other class is discarded, with a warning."""
    edges = _edges()
    fresh = BUILDERS["reledges"](edges, str(tmp_path))
    (entry,) = os.listdir(tmp_path)
    with np.load(tmp_path / entry) as data:
        arrays = {k: data[k] for k in data.files}
    tree = arrays["__tree__"].tobytes().replace(b'"RelEdges"', b'"Popen"')
    arrays["__tree__"] = np.frombuffer(tree, np.uint8)
    np.savez(tmp_path / entry, **arrays)
    with pytest.warns(UserWarning, match="not a plan class"):
        plan = BUILDERS["reledges"](edges, str(tmp_path))
    assert_same_plan(plan, fresh)


def test_key_is_stable_across_processes():
    edges = _edges()
    here = plancache.plan_key("reledges", edges, (N, SLOTS, True))
    code = ("import numpy as np\n"
            "from scaling_rgcn_training_tpu_torch.utils import plancache\n"
            f"rng = np.random.default_rng(0)\n"
            f"e = [rng.integers(0, {N}, {E}).astype(np.int32) for _ in range(2)]\n"
            f"e.append(rng.integers(0, {SLOTS - 1}, {E}).astype(np.int32))\n"
            f"print(plancache.plan_key('reledges', e, ({N}, {SLOTS}, True)))\n")
    for seed in ("1", "2"):
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
            text=True, timeout=120, check=True,
            env=dict(os.environ, PYTHONPATH=ROOT, PYTHONHASHSEED=seed))
        assert out.stdout.strip() == here


def test_to_device_moves_every_tensor_and_keeps_sharing():
    plan = BUILDERS["reledges"](_edges(), None)
    moved = plantree.to_device(plan, "meta")
    assert moved.src.device.type == "meta"
    assert moved.span.fwd_src.device.type == "meta"
    assert moved.src is moved.span.rel_src
    assert moved.group_offsets == plan.group_offsets
