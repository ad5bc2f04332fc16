"""The port's binding of the native N-Triples parser (``graphs/_native.py``)
against its pure-Python parse and the JAX package's native parse."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from scaling_rgcn_training_tpu.graphs import _native as j_native
from scaling_rgcn_training_tpu.graphs import nt as j_nt
from scaling_rgcn_training_tpu.graphs.graph import Graph as JGraph
from scaling_rgcn_training_tpu_torch.graphs import _native, nt
from scaling_rgcn_training_tpu_torch.graphs import processing as proc
from scaling_rgcn_training_tpu_torch.graphs.dataset import Dataset
from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
from scaling_rgcn_training_tpu_torch.graphs.synthetic import ensure_synthetic_dataset

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build native/ntgraph.cpp")


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    return ensure_synthetic_dataset(str(tmp_path_factory.mktemp("g")),
                                    num_entities=400, num_relations=7,
                                    avg_degree=5.0, seed=5)


FILES = ["SYNTH_complete.nt", "attr/sum/SYNTH_sum_in_out.nt",
         "attr/map/SYNTH_map_out.nt"]


def _same_graph(a, b):
    assert a.nodes == b.nodes
    assert a.node_to_enum == b.node_to_enum
    assert a.relations == b.relations
    assert a.num_edges == b.num_edges
    for k in ("edge_src", "edge_dst", "edge_type"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y), k


@needs_gxx
@pytest.mark.parametrize("rel", FILES)
def test_native_parse_equals_python_and_jax(ds_dir, rel):
    """The same graph as the port's and the JAX package's Python parses
    and the JAX package's native parse."""
    path = os.path.join(ds_dir, rel)
    py = Graph("python")
    py.init_graph(nt.read_lines(path))
    native = Graph("native")
    pairs = native.init_from_native(path)
    assert pairs is not None
    _same_graph(native, py)
    j_py = JGraph("jax python")
    j_py.init_graph(j_nt.read_lines(path))
    _same_graph(native, j_py)
    if j_native.get_lib() is None:
        pytest.skip("the JAX package's native library is not built")
    nodes, rels, src, dst, typ, n_uniq, j_pairs = j_native.parse_graph(path)
    assert nodes == native.nodes and rels == sorted(native.relations)
    assert n_uniq == native.num_edges and j_pairs == pairs
    for a, b in ((src, native.edge_src), (dst, native.edge_dst),
                 (typ, native.edge_type)):
        assert np.array_equal(a, b)


@needs_gxx
def test_native_type_pairs_give_the_python_labels(ds_dir):
    path = os.path.join(ds_dir, "SYNTH_complete.nt")
    triples = nt.read_triples(path)
    pairs = Graph("native").init_from_native(path)
    classes = proc.get_classes(triples)
    assert proc.get_classes_from_pairs(pairs) == classes
    assert dict(proc.nodes2type_from_pairs(pairs, classes)) == \
        dict(proc.nodes2type_mapping(triples, classes))


@needs_gxx
def test_dataset_native_equals_python(ds_dir):
    paths = (os.path.join(ds_dir, "SYNTH_complete.nt"),
             os.path.join(ds_dir, "attr", "sum"),
             os.path.join(ds_dir, "attr", "map"))
    before = _native.PARSES
    d_n = Dataset(*paths).init_dataset(verbose=False)
    assert _native.PARSES == before + 4       # the graph and 3 summaries
    d_p = Dataset(*paths).init_dataset(verbose=False, use_native=False)
    assert _native.PARSES == before + 4
    assert d_n.enum_classes == d_p.enum_classes
    _same_graph(d_n.orgGraph, d_p.orgGraph)
    for k in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        assert np.array_equal(getattr(d_n.orgGraph, k), getattr(d_p.orgGraph, k))
    for a, b in zip(d_n.sumGraphs, d_p.sumGraphs):
        _same_graph(a, b)
        assert np.array_equal(a.y_train, b.y_train)


@needs_gxx
def test_library_is_built_into_the_build_directory(ds_dir):
    """Named by the source's digest, under ``build/torch_native``; nothing
    is written into ``native/``."""
    native_dir = _native.SOURCE.parent
    listing = sorted(p.name for p in native_dir.rglob("*"))
    assert _native.get_lib() is not None
    path = _native.library_path()
    assert path.parent == _native.BUILD_DIR and path.exists()
    assert path.name.startswith("libntgraph_") and len(path.stem) == 27
    assert sorted(p.name for p in native_dir.rglob("*")) == listing


def test_failed_compile_raises_on_every_call(tmp_path, monkeypatch):
    """A compile that fails raises on the first call and again on the
    next: no later call quietly falls back to the Python parse."""
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_no_gxx", False)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(_native.shutil, "which", lambda name: "/usr/bin/g++")
    calls = []

    def broken(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "error: broken")

    monkeypatch.setattr(_native.subprocess, "run", broken)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _native.get_lib()
    assert len(calls) == 2


def test_without_gxx_says_so_once_and_parses_in_python(ds_dir, tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_no_gxx", False)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    paths = (os.path.join(ds_dir, "SYNTH_complete.nt"),
             os.path.join(ds_dir, "attr", "sum"),
             os.path.join(ds_dir, "attr", "map"))
    d = Dataset(*paths).init_dataset(verbose=False)
    assert capsys.readouterr().err.count("no g++ found") == 1
    assert not (tmp_path / "none").exists()
    d_p = Dataset(*paths).init_dataset(verbose=False, use_native=False)
    _same_graph(d.orgGraph, d_p.orgGraph)
    assert np.array_equal(d.orgGraph.y_test, d_p.orgGraph.y_test)
