"""Port host layer against the JAX package's: synthetic data, attribute
summaries, murmur hashing, the dataset with its splits, and the
summation embedding transfer. Everything here is exact."""

import math
import os

import numpy as np
import pytest
import jax
import torch
from sklearn.model_selection import train_test_split as sk_split

from scaling_rgcn_training_tpu.graphs import dataset as jdataset
from scaling_rgcn_training_tpu.graphs import synthetic as jsynth
from scaling_rgcn_training_tpu.graphs.summarize import murmur as jmurmur
from scaling_rgcn_training_tpu.train import transfer as jtransfer
from scaling_rgcn_training_tpu_torch.graphs import dataset as tdataset
from scaling_rgcn_training_tpu_torch.graphs import synthetic as tsynth
from scaling_rgcn_training_tpu_torch.graphs.summarize import murmur as tmurmur
from scaling_rgcn_training_tpu_torch.train import transfer as ttransfer


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same tiny SYNTH dataset written and loaded by both packages."""
    kw = dict(num_entities=400, num_relations=6, num_classes=3,
              avg_degree=4.0, seed=5, labeled_fraction=0.4)
    roots = [str(tmp_path_factory.mktemp(n)) for n in ("jax", "torch")]
    dirs = [jsynth.ensure_synthetic_dataset(roots[0], **kw),
            tsynth.ensure_synthetic_dataset(roots[1], **kw)]
    loaded = []
    for mod, d in zip((jdataset, tdataset), dirs):
        args = (os.path.join(d, "SYNTH_complete.nt"),
                os.path.join(d, "attr", "sum"), os.path.join(d, "attr", "map"))
        loaded.append(mod.Dataset(*args).init_dataset(verbose=False))
    return dirs, loaded


def test_synthetic_files_are_identical(datasets):
    (jdir, tdir), _ = datasets
    jfiles, tfiles = _files(jdir), _files(tdir)
    assert sorted(jfiles) == sorted(tfiles) and len(jfiles) == 7
    for name in jfiles:
        assert jfiles[name] == tfiles[name], name


def _same_graph(a, b):
    assert a.name == b.name
    assert a.nodes == b.nodes and a.relations == b.relations
    assert (a.num_nodes, a.num_edges) == (b.num_nodes, b.num_edges)
    for f in ("edge_src", "edge_dst", "edge_type", "x_train", "y_train",
              "x_val", "y_val", "x_test", "y_test"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_dataset_matches_jax(datasets):
    _, (jd, td) = datasets
    assert jd.enum_classes == td.enum_classes and jd.num_classes == td.num_classes
    _same_graph(jd.orgGraph, td.orgGraph)
    assert len(td.orgGraph.x_val) and len(td.orgGraph.x_test)
    assert len(jd.sumGraphs) == len(td.sumGraphs) == 3
    for js, ts in zip(jd.sumGraphs, td.sumGraphs):
        _same_graph(js, ts)
        assert js.orgNode2sumNode_dict == ts.orgNode2sumNode_dict
        assert js.sumNode2orgNode_dict == ts.sumNode2orgNode_dict
        assert js.sum2type == ts.sum2type


@pytest.mark.parametrize("n", [1, 2, 5, 9, 10, 37, 100])
def test_split_matches_sklearn(n):
    """Both calls of the dataset split, index for index."""
    x = list(range(3, 3 + n))
    y = [[i % 3, i % 2] for i in range(n)]
    if n >= 2:
        ref = sk_split(x, y, test_size=0.2, random_state=1, shuffle=True)
        got = tdataset.train_test_split(x, y, test_size=0.2)
        assert [list(a) for a in got] == [list(a) for a in ref]
    ref = sk_split(x * 2, y * 2, test_size=0.25, random_state=1, shuffle=True)
    got = tdataset.train_test_split(x * 2, y * 2, test_size=0.25)
    assert [list(a) for a in got] == [list(a) for a in ref]
    assert len(got[1]) == math.ceil(0.25 * 2 * n)


@pytest.mark.parametrize("key", ["", "a", "rdf:type", "x" * 15, "y" * 16,
                                 "z" * 17, "é,ü," * 9])
def test_murmur_matches_jax(key):
    assert tmurmur.hash128(key) == jmurmur.hash128(key)


def test_sum_embeddings_matches_jax_on_mapped_rows(datasets):
    """Rows of the summation trick that every summary maps are the sum of
    the summary embeddings' rows in both packages (other rows are random
    U[0, 1) draws of each framework's generator)."""
    _, (jd, td) = datasets
    rng = np.random.default_rng(8)
    for js, ts in zip(jd.sumGraphs, td.sumGraphs):
        js.embedding = ts.embedding = rng.standard_normal(
            (ts.num_nodes, 6)).astype(np.float32)
    ref = np.asarray(jtransfer.sum_embeddings(jd.orgGraph, jd.sumGraphs, 6,
                                              jax.random.key(0)))
    got = ttransfer.sum_embeddings(td.orgGraph, td.sumGraphs, 6,
                                   torch.Generator().manual_seed(0)).numpy()
    assert got.shape == ref.shape == (td.orgGraph.num_nodes, 6)
    hits = np.array([[sg.orgNode2sumNode_dict.get(node) in sg.node_to_enum
                      for node in td.orgGraph.nodes] for sg in td.sumGraphs])
    mapped, unmapped = hits.all(0), ~hits.any(0)
    assert mapped.sum() > 100
    np.testing.assert_allclose(got[mapped], ref[mapped], rtol=1e-6)
    assert ((got[unmapped] >= 0) & (got[unmapped] < 3)).all()
