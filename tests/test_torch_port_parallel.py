"""The port's edge partition, reorder, multi-device Trainer and CLI
against the JAX package, on the CPU.

The JAX side runs on 4 of the 8 virtual CPU devices (tests/conftest.py);
the port on a mesh of 4 virtual CPU shards. Tolerances: float32 convs
within 1e-5 * max|ref| (other summation order); Trainer loss series rtol
1e-4, validation accuracies within one validation row, final parameters
rtol 1e-4 with atol 1e-6 (as tests/test_torch_port_train.py).
"""

import glob
import json
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaling_rgcn_training_tpu.graphs.device import build_device_graph as j_build
from scaling_rgcn_training_tpu.models import heads as jheads
from scaling_rgcn_training_tpu.ops import init_rgcn_layer as j_init_layer
from scaling_rgcn_training_tpu.parallel import reorder as jreorder
from scaling_rgcn_training_tpu.parallel import spmd as jspmd
from scaling_rgcn_training_tpu.parallel.mesh import make_mesh as j_make_mesh
from scaling_rgcn_training_tpu.train import losses as jlosses
from scaling_rgcn_training_tpu.train.trainer import Trainer as JTrainer
from scaling_rgcn_training_tpu_torch import main as tmain
from scaling_rgcn_training_tpu_torch.graphs.device import (
    build_device_graph as t_build, model_num_nodes)
from scaling_rgcn_training_tpu_torch.models.heads import emb_model_from_numpy
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer
from scaling_rgcn_training_tpu_torch.parallel import reorder as treorder
from scaling_rgcn_training_tpu_torch.parallel import spmd as tspmd
from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh, use_mesh
from scaling_rgcn_training_tpu_torch.train import losses as tlosses
from scaling_rgcn_training_tpu_torch.train.trainer import Trainer as TTrainer

S = 4


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} virtual JAX devices")
    return j_make_mesh(S)


def _clustered(seed=0, n=54, e=300, r=4, intra=0.9):
    """Four communities under scattered node ids; ``intra`` of the edges
    stay inside their source's community."""
    rng = np.random.default_rng(seed)
    comm = rng.permutation(n) % 4
    members = [np.flatnonzero(comm == k) for k in range(4)]
    src = rng.integers(0, n, e)
    inside = np.array([rng.choice(members[comm[s]]) for s in src])
    dst = np.where(rng.random(e) < intra, inside, rng.integers(0, n, e))
    typ = rng.integers(0, 2 * r, e)
    return (src.astype(np.int32), dst.astype(np.int32), typ.astype(np.int32),
            n, 2 * r + 1)


def test_sharded_conv_matches_jax(jmesh):
    """The edge partition's host arrays equal the JAX build's; its conv's
    values and gradients match the JAX ``sharded_rgcn_conv``."""
    src, dst, typ, n, slots = _clustered(seed=1)
    jedges = jspmd.shard_rel_edges(src, dst, typ, n, slots, S,
                                   pad_to_multiple=8)
    tedges = tspmd.shard_rel_edges(src, dst, typ, n, slots, S,
                                   pad_to_multiple=8)
    for f in ("src", "dst", "norm", "group_sizes"):
        np.testing.assert_array_equal(getattr(tedges, f),
                                      np.asarray(getattr(jedges, f)), err_msg=f)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    g = rng.standard_normal((n, 6)).astype(np.float32)
    params = j_init_layer(jax.random.key(1), slots, 8, 6)
    jdev = jspmd.device_put_sharded_edges(jedges, jmesh)
    (_, out), (gp, gx) = jax.value_and_grad(
        lambda p, xv: (lambda o: (jnp.sum(o * g), o))(jspmd.sharded_rgcn_conv(
            xv, jdev, p, jmesh, backend="gather")),
        argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    ref = [np.asarray(a) for a in (out, gx, gp.weight, gp.root, gp.bias)]

    tmesh = make_mesh(devices=("cpu",) * S)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    layer = RGCNLayer(t(params.weight), t(params.root), t(params.bias))
    xt = torch.tensor(x, requires_grad=True)
    out = tspmd.sharded_rgcn_conv(
        xt, tspmd.device_put_sharded_edges(tedges, tmesh), layer, tmesh)
    (out * torch.tensor(g)).sum().backward()
    got = [out, xt.grad, layer.weight.grad, layer.root.grad, layer.bias.grad]
    for name, a, b in zip(("out", "dx", "dW", "droot", "dbias"), got, ref):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("num_shards", [None, S])
def test_locality_reorder_matches_jax(num_shards):
    src, dst, _, n, _ = _clustered(seed=3, n=200, e=1200)
    got = treorder.locality_reorder(src, dst, n, num_shards=num_shards)
    want = jreorder.locality_reorder(src, dst, n, num_shards=num_shards)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))
    if num_shards:     # the clustered graph keeps the shard-aware relabeling
        assert not np.array_equal(got, np.arange(n))
        assert treorder.edge_cut_fraction(src, dst, n, S, got) < \
            treorder.edge_cut_fraction(src, dst, n, S)


def test_max_peer_halo_is_exact_past_int32():
    """N = 2^20 nodes over 64 shards: the pair key reaches S^2 * N = 2^32,
    past int32; the count matches an int64 brute force."""
    n, s_n, e = 1 << 20, 64, 20000
    rng = np.random.default_rng(4)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    perm = rng.permutation(n).astype(np.int32)
    got = treorder._max_peer_halo(src, dst, n, s_n, perm)
    ps, pd = perm[src].astype(np.int64), perm[dst].astype(np.int64)
    n_per = -(-n // s_n)
    cross = ps // n_per != pd // n_per
    triples = np.unique(np.stack([pd[cross] // n_per, ps[cross] // n_per,
                                  ps[cross]], axis=1), axis=0)
    _, per_pair = np.unique(triples[:, :2], axis=0, return_counts=True)
    assert got == int(per_pair.max())


def _trainer_graph(seed=5, n=54, e=300, r=4, c=3):
    src, dst, typ, n, slots = _clustered(seed, n, e, r, intra=0.95)
    rng = np.random.default_rng(seed + 1)
    labelled = rng.choice(n, 36, replace=False)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, 36)]
    return SimpleNamespace(
        edge_src=src, edge_dst=dst, edge_type=typ, num_nodes=n,
        num_relation_slots=slots, num_classes=c,
        x_train=labelled[:24].astype(np.int32), y_train=y[:24],
        x_val=labelled[24:].astype(np.int32), y_val=y[24:],
        x_test=None, y_test=None)


@pytest.mark.parametrize("partition,reorder", [("halo", False),
                                               ("halo", True),
                                               ("edge", False)])
def test_trainer_devices_matches_jax_and_single_device(jmesh, partition,
                                                       reorder):
    """``Trainer(devices=4)`` of the port against the JAX one from the same
    parameters (laid out for the partition), and against the port's
    single-device run."""
    g = _trainer_graph()
    emb, hl, epochs = 8, 6, 5
    params = jheads.init_emb_model(jax.random.key(0), g.num_relation_slots,
                                   hl, g.num_classes, g.num_nodes, emb)
    kw = dict(hidden_l=hl, epochs=epochs, emb_dim=emb, lr=0.01, weight_d=5e-5)
    jt = JTrainer(None, backend="gather", devices=S, partition=partition,
                  reorder=reorder, **kw)
    jg = j_build(g, mesh=jt.mesh, partition=partition, reorder=reorder)
    jparams = params._replace(embedding=jt._pad_embedding(
        params.embedding, jg, g.num_nodes))
    jloss, act = jlosses.get_loss("SYNTH", sum_model=False)
    jparams, jaccs, jl, _, _ = jt.fit(jparams, jheads.apply_emb_model, jg,
                                      jloss, act, sum_graph=False,
                                      verbose=False)

    tt = TTrainer(None, device="cpu", devices=S, partition=partition,
                  reorder=reorder, **kw)
    tg = t_build(g, "cpu", mesh=tt.mesh, partition=partition, reorder=reorder)
    if reorder:
        np.testing.assert_array_equal(tg.node_perm, np.asarray(jg.node_perm))
        assert not np.array_equal(tg.node_perm, np.arange(g.num_nodes))
    model = emb_model_from_numpy(np.asarray(params.embedding),
                                 list(params.rgcn1), list(params.rgcn2))
    model.embedding = torch.nn.Parameter(
        tt._pad_embedding(model.embedding.detach(), tg))
    assert model.embedding.shape[0] == model_num_nodes(tg)
    tloss, tact = tlosses.get_loss("SYNTH", sum_model=False)
    model, taccs, tl, _, _ = tt.fit(model, tg, tloss, tact, sum_graph=False,
                                    verbose=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(taccs, jaccs, rtol=0,
                               atol=1.0 / len(g.x_val) + 1e-7)
    got = [model.embedding, *model.rgcn1.parameters(),
           *model.rgcn2.parameters()]
    for t, ref in zip(got, jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6)

    single = emb_model_from_numpy(np.asarray(params.embedding),
                                  list(params.rgcn1), list(params.rgcn2))
    st = TTrainer(None, device="cpu", **kw)
    single, saccs, sl, _, _ = st.fit(single, t_build(g, "cpu"), tloss, tact,
                                     sum_graph=False, verbose=False)
    np.testing.assert_allclose(tl, sl, rtol=1e-4)
    np.testing.assert_allclose(
        tt._export_embedding(model.embedding, tg, g.num_nodes),
        single.embedding.detach().numpy(), rtol=1e-4, atol=1e-6)


def test_attention_with_devices_raises():
    with pytest.raises(ValueError, match="single-device"):
        TTrainer(None, 6, 1, 8, 0.01, 5e-5, device="cpu", devices=S,
                 aggr="attention")


def test_partitioned_edges_outside_a_mesh_raise():
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import rgcn_conv

    g = _trainer_graph()
    mesh = make_mesh(devices=("cpu",) * S)
    tg = t_build(g, "cpu", mesh=mesh, partition="halo")
    layer = RGCNLayer(torch.zeros(g.num_relation_slots, 8, 6),
                      torch.zeros(8, 6), torch.zeros(6))
    x = torch.zeros(model_num_nodes(tg), 8)
    with pytest.raises(RuntimeError, match="use_mesh"):
        rgcn_conv(x, tg.edges, layer)
    with use_mesh(mesh):
        assert rgcn_conv(x, tg.edges, layer).shape == (model_num_nodes(tg), 6)


def test_cuda_mesh_needs_as_many_cards(monkeypatch):
    """``-devices 4 -device cuda`` on a machine with one card raises; no
    fallback to the CPU or to fewer shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="mesh of 4 CUDA devices, have 1"):
        TTrainer(None, 6, 1, 8, 0.01, 5e-5, device="cuda", devices=S)


@pytest.mark.parametrize("partition", ["halo", "edge"])
def test_cli_devices_on_cpu(tmp_path, partition, capsys):
    """``-device cpu -devices 4``: summary pre-training, transfer and
    fine-tuning over 4 virtual CPU shards; the report carries the flags."""
    args = ["-dataset", "SYNTH", "-exp", "summation", "-epochs", "3", "-i",
            "1", "-emb", "12", "-hl", "8", "-synth_entities", "300",
            "-data_root", str(tmp_path / "data"),
            "-results_root", str(tmp_path / "results"), "-device", "cpu",
            "-devices", "4", "-partition", partition]
    tmain.main(args + (["-reorder"] if partition == "halo" else []))
    assert "ACC ON TEST SET" in capsys.readouterr().out
    (report,) = glob.glob(str(tmp_path / "results" / "*" / "report_*.json"))
    report = json.load(open(report))
    assert report["devices"] == 4 and report["partition"] == partition
    assert 0.0 <= report["Test acc summation"]["mean"] <= 100.0
