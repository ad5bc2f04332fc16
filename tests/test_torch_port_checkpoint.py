"""Checkpoint and resume of the port (``utils/checkpoint.py``,
``Trainer.fit(ckpt_path=...)``, ``train_summaries(save_path=...)`` /
``load_summaries``) against unbroken runs and the JAX package's files."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from scaling_rgcn_training_tpu.ops.rgcn_conv import init_rgcn_layer as j_init_layer
from scaling_rgcn_training_tpu.train.transfer import sum_embeddings as j_sum_embeddings
from scaling_rgcn_training_tpu.utils import checkpoint as jck
from scaling_rgcn_training_tpu_torch.graphs import device as device_mod
from scaling_rgcn_training_tpu_torch.graphs.dataset import Dataset
from scaling_rgcn_training_tpu_torch.graphs.processing import mapping_index_arrays
from scaling_rgcn_training_tpu_torch.graphs.synthetic import ensure_synthetic_dataset
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    build_rel_edges, init_rgcn_layer)
from scaling_rgcn_training_tpu_torch.train.trainer import Trainer
from scaling_rgcn_training_tpu_torch.utils import checkpoint as ck
from scaling_rgcn_training_tpu_torch.utils.viz import save_and_viz_embedding

EPOCHS, EVERY, CRASH = 10, 2, 4


class Crash(Exception):
    pass


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread per test: the small ops of these fits slow down
    many times over when several test workers share the cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _data(root):
    ds = ensure_synthetic_dataset(str(root), name="SYNTH", num_entities=150,
                                  num_relations=4, num_classes=3,
                                  avg_degree=4.0, seed=4)
    return Dataset(os.path.join(ds, "SYNTH_complete.nt"),
                   os.path.join(ds, "attr", "sum"),
                   os.path.join(ds, "attr", "map")).init_dataset(verbose=False)


def _configs(e_freeze):
    return {"dataset": "SYNTH", "num_sums": 3, "e_trans": True,
            "e_freeze": e_freeze, "w_trans": True, "w_grad": True}


def _trainer(root, seed, ckpt_dir=None, devices=None, **kw):
    return Trainer(_data(root), hidden_l=6, epochs=EPOCHS, emb_dim=9,
                   lr=0.01, weight_d=5e-5, seed=seed, device="cpu",
                   devices=devices, ckpt_dir=ckpt_dir,
                   ckpt_every=EVERY if ckpt_dir else 0, **kw)


def _crash_after(trainer, epochs):
    """Make the trainer's checkpointed fit raise after ``epochs`` epochs."""
    fit = trainer.fit

    def crashing_fit(*args, **kw):
        def hook(epoch):
            if epoch + 1 == epochs:
                raise Crash
        return fit(*args, on_epoch=hook if kw.get("ckpt_path") else None,
                   **kw)
    trainer.fit = crashing_fit


def _run(trainer, head, configs):
    trainer.train_summaries(configs, verbose=False)
    return trainer.train_original(head, configs, head, verbose=False)


def _same_result(a, b):
    for key in ("loss", "accuracy", "f1 weighted", "f1 macro", "test_acc",
                "test_f1_weighted", "test_f1_macro"):
        assert a[key] == b[key], key


def test_npz_round_trip_same_bits(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"params/w": rng.standard_normal((5, 7)).astype(np.float32),
              "params/e": torch.randn(3, 4, dtype=torch.float64),
              "opt/w/step": np.float32(3), "rng/x": np.arange(9, dtype=np.uint8)}
    out = ck.save_checkpoint(str(tmp_path / "sub" / "ck"), arrays, epoch=6,
                             extra={"series": {"loss": [0.5, 0.25]}})
    assert out.endswith("ck.npz") and ck.checkpoint_exists(out)
    got, meta = ck.load_checkpoint(str(tmp_path / "sub" / "ck"))
    assert meta == {"epoch": 6, "series": {"loss": [0.5, 0.25]}}
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        assert got[k].dtype == v.dtype
        assert got[k].tobytes() == v.tobytes()
    assert sorted(os.listdir(tmp_path / "sub")) == ["ck.npz", "ck.npz.meta.json"]
    # a meta file of another epoch (a write cut between the files) raises
    ck.save_checkpoint(str(tmp_path / "other"), arrays, epoch=8)
    os.replace(tmp_path / "other.npz.meta.json", out + ".meta.json")
    with pytest.raises(ValueError, match="epoch"):
        ck.load_checkpoint(out)


@pytest.mark.parametrize("mode,head,e_freeze", [
    ("fused", "summation", True), ("fused", "summation", False),
    ("edge", "summation", True), ("edge", "summation", False),
    ("halo", "summation", True), ("halo", "summation", False),
    ("fused", "attention", False),
])
def test_resume_equals_unbroken_run(tmp_path, monkeypatch, mode, head,
                                    e_freeze):
    """Crash after 4 of 10 epochs (checkpoints every 2), resume with a
    Trainer of another seed: the losses, validation series and test
    metrics equal the unbroken run's. ``edge``: the graph built without
    the span plan (edge mode, ``backend="gather"``); ``halo``: 2 virtual
    CPU shards (phantom rows in the node table); the attention head
    restores its dropout generator."""
    kw = {"devices": 2} if mode == "halo" else {}
    if mode == "edge":
        kw["backend"] = "gather"
        monkeypatch.setattr(device_mod, "build_rel_edges",
                            functools.partial(build_rel_edges, span=False))
    configs = _configs(e_freeze)
    full = _run(_trainer(tmp_path / "a", seed=0, **kw), head, configs)

    ckpt = str(tmp_path / "ck")
    crashed = _trainer(tmp_path / "b", seed=0, ckpt_dir=ckpt, **kw)
    _crash_after(crashed, CRASH)
    with pytest.raises(Crash):
        _run(crashed, head, configs)
    name = f"fit_SYNTH_{head}.npz"
    assert sorted(os.listdir(ckpt)) == [name, name + ".meta.json"]
    assert ck.load_checkpoint(os.path.join(ckpt, name))[1]["epoch"] == CRASH

    resumed = _run(_trainer(tmp_path / "c", seed=99, ckpt_dir=ckpt, **kw),
                   head, configs)
    _same_result(resumed, full)
    assert len(resumed["loss"]) == EPOCHS
    assert ck.load_checkpoint(os.path.join(ckpt, name))[1]["epoch"] == EPOCHS
    other = _run(_trainer(tmp_path / "d", seed=99, **kw), head, configs)
    assert other["loss"] != full["loss"]     # the seed alone does not do it


@pytest.mark.parametrize("write,read", [(2, None), (None, 2)])
def test_checkpoint_moves_between_shard_counts(tmp_path, write, read):
    """A fit checkpoint written over 2 virtual shards restores onto one
    device, and the other way round: the same parameters in true node
    order and the same metric series."""
    configs = _configs(False)
    ckpt = str(tmp_path / "ck")
    a = _trainer(tmp_path / "a", seed=0, ckpt_dir=ckpt, devices=write)
    res_a = _run(a, "summation", configs)
    b = _trainer(tmp_path / "b", seed=7, ckpt_dir=ckpt, devices=read)
    res_b = _run(b, "summation", configs)
    assert res_b["loss"] == res_a["loss"]
    assert res_b["accuracy"] == res_a["accuracy"]
    for (name, pa), (_, pb) in zip(res_a["model"].named_parameters(),
                                   res_b["model"].named_parameters()):
        if name == "embedding":
            n = a.data.orgGraph.num_nodes
            pa = a._export_embedding(pa, a._device_graph(a.data.orgGraph), n)
            pb = b._export_embedding(pb, b._device_graph(b.data.orgGraph), n)
        assert np.asarray(pa.detach() if torch.is_tensor(pa) else pa).tobytes() \
            == np.asarray(pb.detach() if torch.is_tensor(pb) else pb).tobytes(), name


def _trunks(num_bases):
    rng = np.random.default_rng(3)
    slots, d, h, c = 9, 6, 5, 3
    layers = []
    for i, (a, b) in enumerate(((d, h), (h, c))):
        w_shape = (num_bases or slots, a, b)
        layer = {"weight": rng.standard_normal(w_shape).astype(np.float32),
                 "root": rng.standard_normal((a, b)).astype(np.float32),
                 "bias": rng.standard_normal(b).astype(np.float32)}
        if num_bases:
            layer["comp"] = rng.standard_normal((slots, num_bases)).astype(np.float32)
        layers.append(layer)
    embs = [rng.standard_normal((n, d)).astype(np.float32) for n in (7, 4, 11)]
    return layers, embs, (slots, d, h, c)


@pytest.mark.parametrize("num_bases", [None, 2])
def test_transfer_state_moves_between_packages(tmp_path, num_bases):
    """A file of JAX ``save_transfer_state`` loads through the port's
    ``load_transfer_state`` to the same arrays, and the port's file loads
    in JAX ``load_transfer_state``: the JAX key layout both ways."""
    layers, embs, (slots, d, h, c) = _trunks(num_bases)
    key = jax.random.key(0)
    j_trunk = tuple(j_init_layer(key, slots, a, b, num_bases=num_bases)
                    for a, b in ((d, h), (h, c)))
    j_trunk = tuple(t._replace(**layer) for t, layer in zip(j_trunk, layers))
    jpath = jck.save_transfer_state(str(tmp_path / "jax"), j_trunk, embs)
    trunk, got = ck.load_transfer_state(jpath)
    assert [sorted(t) for t in trunk] == [sorted(l) for l in layers]
    for t, layer in zip(trunk, layers):
        for k, v in layer.items():
            assert t[k].tobytes() == v.tobytes() and t[k].shape == v.shape
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, embs))

    gen = torch.Generator().manual_seed(0)
    p_trunk = [init_rgcn_layer(gen, slots, a, b, num_bases=num_bases)
               for a, b in ((d, h), (h, c))]
    with torch.no_grad():
        for t, layer in zip(p_trunk, layers):
            for k, v in layer.items():
                getattr(t, k).copy_(torch.from_numpy(v))
    ppath = ck.save_transfer_state(str(tmp_path / "port"), p_trunk, embs)
    with np.load(jpath) as jf, np.load(ppath) as pf:
        assert sorted(jf.files) == sorted(pf.files)
    (r1, r2), jembs = jck.load_transfer_state(ppath, j_trunk)
    for t, layer in zip((r1, r2), layers):
        for k, v in layer.items():
            np.testing.assert_array_equal(np.asarray(getattr(t, k)), v)
    assert all(np.array_equal(a, b) for a, b in zip(jembs, embs))


@pytest.mark.parametrize("head", ["summation", "mlp", "attention"])
def test_train_original_after_load_summaries_equals_trained(tmp_path, head):
    """``train_summaries(save_path=...)`` then ``load_summaries`` on a new
    Trainer (another seed, its generator where the first trainer's
    ``train_summaries`` left it): the fine-tuning gives the same bits."""
    configs = _configs(True)
    path = str(tmp_path / "transfer_SYNTH_0.npz")
    t1 = _trainer(tmp_path / "a", seed=0)
    t1.train_summaries(configs, verbose=False, save_path=path)
    state = t1.gen.get_state()
    res1 = t1.train_original(head, configs, head, verbose=False)

    t2 = _trainer(tmp_path / "b", seed=5)
    t2.load_summaries(path)
    for a, b in zip(t1.data.sumGraphs, t2.data.sumGraphs):
        assert a.embedding.tobytes() == b.embedding.tobytes()
    for m in ("rgcn1", "rgcn2"):
        for (n, p), (_, q) in zip(getattr(t1.sum_model, m).named_parameters(),
                                  getattr(t2.sum_model, m).named_parameters()):
            assert torch.equal(p, q), (m, n)
    t2.gen.set_state(state)
    res2 = t2.train_original(head, configs, head, verbose=False)
    _same_result(res2, res1)


def test_e_viz_saves_the_transferred_embedding(tmp_path):
    """The ``.npy`` equals the embedding the summation head started from
    (frozen, so the trained model still holds it); its rows that every
    summary maps equal JAX ``sum_embeddings`` of the same summary
    embeddings."""
    configs = _configs(True)
    t = _trainer(tmp_path, seed=0)
    res = _run(t, "summation", configs)
    path = save_and_viz_embedding(
        {**configs, "sum": "attr", "results_root": str(tmp_path / "res")},
        res["embedding"])
    saved = np.load(path)
    og = t.data.orgGraph
    assert saved.shape == (og.num_nodes, 9)
    model_emb = t._export_embedding(res["model"].embedding,
                                    t._device_graph(og), og.num_nodes)
    assert saved.tobytes() == model_emb.tobytes()
    every = None
    for sg in t.data.sumGraphs:
        rows = set(mapping_index_arrays(og, sg)[0].tolist())
        every = rows if every is None else every & rows
    rows = np.array(sorted(every))
    assert len(rows) > 0
    want = np.asarray(j_sum_embeddings(og, t.data.sumGraphs, 9,
                                       jax.random.key(0)))
    np.testing.assert_allclose(saved[rows], want[rows], rtol=1e-6)
