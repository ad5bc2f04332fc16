"""The port's node-sharded layout (``parallel/mesh.py`` ``NodeRows``: one
tensor a shard, each on its shard's device) against the JAX package's
``node_sharding``, on the CPU.

The JAX side places its arrays with ``put_global``/``device_put`` on
``node_sharding`` over the first S of the 8 virtual CPU devices of
``tests/conftest.py``; the port over S virtual CPU shards, where kernels
#6 and #7 run their plain versions. Same graph and inputs from one numpy
seed, weights carried across as numpy. Tolerances: float32 within rtol
1e-5 and atol 1e-6 * max|ref| (other summation order: the port adds each
shard's root term and its cotangents shard by shard); Adam and the
checkpoint bit for bit.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from scaling_rgcn_training_tpu.ops import init_rgcn_layer as j_init_layer
from scaling_rgcn_training_tpu.parallel import halo as jhalo
from scaling_rgcn_training_tpu.parallel.mesh import make_mesh as j_make_mesh
from scaling_rgcn_training_tpu_torch import multihost_sim as mh
from scaling_rgcn_training_tpu_torch.models.heads import node_rows_from_numpy
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer
from scaling_rgcn_training_tpu_torch.parallel import halo as thalo
from scaling_rgcn_training_tpu_torch.parallel import mesh as tmesh
from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer

N, D, HL, C = 61, 8, 6, 3
EXCHANGES = {"library": None, "#6": "1", "#7": "fused"}


def _graph(seed, n=N, e=420, r=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 2, e).astype(np.int32)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)
    return src, dst, typ, 2 * r + 1


def _partitions(s_n, seed):
    src, dst, typ, slots = _graph(seed)
    jmesh = j_make_mesh(s_n)
    jhe = jhalo.device_put_halo_edges(jhalo.halo_partition_edges(
        src, dst, typ, N, slots, s_n, pad_to_multiple=8, halo_multiple=4),
        jmesh)
    mesh = tmesh.make_mesh(devices=("cpu",) * s_n)
    the = thalo.device_put_halo_edges(thalo.halo_partition_edges(
        src, dst, typ, N, slots, s_n, pad_to_multiple=8, halo_multiple=4),
        mesh)
    return jmesh, jhe, mesh, the, slots


def _layer(p):
    t = lambda a: torch.tensor(np.asarray(a, np.float32), requires_grad=True)
    return RGCNLayer(t(p.weight), t(p.root), t(p.bias))


def _close(name, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref).max()),
                               err_msg=name)


@pytest.fixture(autouse=True)
def _exchange(monkeypatch):
    monkeypatch.delenv(thalo.EXCHANGE_ENV, raising=False)
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX devices")


@pytest.mark.parametrize("exchange", list(EXCHANGES))
@pytest.mark.parametrize("s_n", [2, 4])
def test_halo_layer_on_node_rows_matches_jax(s_n, exchange, monkeypatch):
    """One halo layer from per-shard rows to per-shard rows: each shard's
    output on its device and, gathered, the JAX conv's node-sharded
    output; the gradients of each shard's rows, ``w``, ``root`` and
    ``bias``."""
    jmesh, jhe, mesh, the, slots = _partitions(s_n, seed=s_n)
    rng = np.random.default_rng(10 + s_n)
    x = jhalo.pad_node_array(rng.standard_normal((N, D)).astype(np.float32),
                             jhe)
    gout = rng.standard_normal((x.shape[0], HL)).astype(np.float32)
    params = j_init_layer(jax.random.key(s_n), slots, D, HL)

    def f(p, xv):
        out = jhalo.halo_rgcn_conv(xv, jhe, p, jmesh, backend="gather")
        return jnp.sum(out * jnp.asarray(gout)), out

    xj = jax.device_put(jnp.asarray(x), jhalo.node_sharding(jmesh))
    (_, out_j), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, xj)

    if EXCHANGES[exchange] is not None:
        monkeypatch.setenv(thalo.EXCHANGE_ENV, EXCHANGES[exchange])
    rows = node_rows_from_numpy(x, mesh)
    layer = _layer(params)
    out = thalo.halo_rgcn_conv(rows, the, layer, mesh)
    assert isinstance(out, tmesh.NodeRows) and len(out) == s_n
    assert out.devices == mesh.devices and out.n_per == the.n_per
    g = tmesh.node_sharding(gout, mesh)
    torch.autograd.backward(out.parts, g.parts)
    _close("out", out.numpy(), out_j)
    _close("dx", np.concatenate([p.grad.numpy() for p in rows.parts]), gx)
    for name in ("weight", "root", "bias"):
        _close(name, getattr(layer, name).grad.numpy(),
               getattr(gp, name))


def _bce(logits, y):
    return jnp.mean(jnp.maximum(logits, 0) - logits * y
                    + jnp.log1p(jnp.exp(-jnp.abs(logits))))


@pytest.mark.parametrize("exchange", list(EXCHANGES))
@pytest.mark.parametrize("s_n", [2, 4])
def test_two_layer_step_on_node_rows_matches_jax(s_n, exchange, monkeypatch):
    """embedding -> halo conv -> ReLU -> halo conv -> BCE on labelled rows
    picked where they lie (``RowPick``): the loss and the gradients of
    each shard's embedding and of both layers against the JAX step on
    node-sharded arrays (``logits[idx]``)."""
    jmesh, jhe, mesh, the, slots = _partitions(s_n, seed=20 + s_n)
    rng = np.random.default_rng(30 + s_n)
    emb = jhalo.pad_node_array(
        rng.standard_normal((N, D)).astype(np.float32), jhe)
    idx = rng.permutation(N)[:17]                 # label order, not sorted
    y = np.eye(C, dtype=np.float32)[np.arange(17) % C]
    p1 = j_init_layer(jax.random.key(1), slots, D, HL)
    p2 = j_init_layer(jax.random.key(2), slots, HL, C)

    def f(a, b, e):
        z = jax.nn.relu(jhalo.halo_rgcn_conv(e, jhe, a, jmesh,
                                             backend="gather"))
        logits = jhalo.halo_rgcn_conv(z, jhe, b, jmesh, backend="gather")
        return _bce(logits[jnp.asarray(idx)], jnp.asarray(y))

    ej = jax.device_put(jnp.asarray(emb), jhalo.node_sharding(jmesh))
    loss_j, grads_j = jax.value_and_grad(f, argnums=(0, 1, 2))(p1, p2, ej)

    if EXCHANGES[exchange] is not None:
        monkeypatch.setenv(thalo.EXCHANGE_ENV, EXCHANGES[exchange])
    rows = node_rows_from_numpy(emb, mesh)
    layers = [_layer(p1), _layer(p2)]
    pick = tmesh.row_pick(idx, the.n_per, mesh.devices)
    z = thalo.halo_rgcn_conv(rows, the, layers[0], mesh).map(torch.relu)
    logits = pick.take(thalo.halo_rgcn_conv(z, the, layers[1], mesh))
    loss = F.binary_cross_entropy_with_logits(logits, torch.tensor(y))
    loss.backward()
    _close("loss", float(loss.detach()), float(loss_j))
    _close("d emb", np.concatenate([p.grad.numpy() for p in rows.parts]),
           grads_j[2])
    for layer, gp in zip(layers, grads_j[:2]):
        for name in ("weight", "root", "bias"):
            _close(name, getattr(layer, name).grad.numpy(),
                   getattr(gp, name))


def test_adam_over_shards_has_one_tables_bits():
    """Adam over the per-shard Parameters against one ``[N, d]``
    Parameter with the same gradients: the same bits after every step,
    the rows and both moments."""
    rng = np.random.default_rng(3)
    mesh = tmesh.make_mesh(devices=("cpu",) * 4)
    table = rng.standard_normal((4 * 13, D)).astype(np.float32)
    rows = node_rows_from_numpy(table, mesh)
    whole = torch.nn.Parameter(torch.tensor(table))
    opts = [make_optimizer(list(rows.parts), 0.01, weight_decay=5e-5),
            make_optimizer([whole], 0.01, weight_decay=5e-5)]
    for _ in range(5):
        g = torch.tensor(rng.standard_normal(table.shape).astype(np.float32))
        whole.grad = g.clone()
        for p, gp in zip(rows.parts, g.split(13)):
            p.grad = gp.clone()
        for opt in opts:
            opt.step()
        assert np.array_equal(rows.numpy(), whole.detach().numpy())
        for moment in ("exp_avg", "exp_avg_sq"):
            shards = torch.cat([opts[0].state[p][moment]
                                for p in rows.parts])
            assert torch.equal(shards, opts[1].state[whole][moment])


@pytest.mark.parametrize("s_n", [2, 4])
def test_pad_placement_and_gather_match_jax(s_n):
    """``pad_node_array``, ``node_sharding`` and the gather on an odd N
    against the JAX functions: the padded array, each shard's rows (the
    JAX array's addressable shard on device ``s``) and the rows put back
    together."""
    jmesh, jhe, mesh, the, _ = _partitions(s_n, seed=40 + s_n)
    x = np.random.default_rng(s_n).standard_normal((N, 5)).astype(np.float32)
    assert N % s_n and the.n_per * s_n > N
    jp = np.asarray(jhalo.pad_node_array(jnp.asarray(x), jhe))
    for tp in (tmesh.pad_node_array(x, the),
               thalo.pad_node_array(torch.tensor(x), the).numpy()):
        assert np.array_equal(tp, jp)
    assert tmesh.pad_node_array(jp, the) is jp         # already padded
    placed = jax.device_put(jnp.asarray(jp), jhalo.node_sharding(jmesh))
    rows = tmesh.node_sharding(jp, mesh)
    assert len(rows) == s_n and rows.n_per == the.n_per
    by_device = {sh.device: np.asarray(sh.data)
                 for sh in placed.addressable_shards}
    for s, part in enumerate(rows.parts):
        assert np.array_equal(part.numpy(), by_device[jmesh.devices[s]])
    assert np.array_equal(rows.numpy(), np.asarray(placed))
    assert np.array_equal(rows.gather().numpy(), np.asarray(placed))
    # the gather under autograd: each shard gets its rows' cotangents
    leaves = rows.as_parameters()
    g = torch.randn(leaves.num_rows, 5)
    (leaves.gather() * g).sum().backward()
    assert torch.equal(torch.cat([p.grad for p in leaves.parts]), g)


def test_row_pick_takes_rows_in_their_order():
    """``RowPick`` over 3 shards: the given rows in their given order, and
    the transpose back to each shard's rows, a shard that owns none of
    them included (zeros, as the JAX gather's transpose gives it); no
    rows give an empty pick that autograd still reaches."""
    mesh = tmesh.make_mesh(devices=("cpu",) * 3)
    table = torch.arange(3 * 4 * 2, dtype=torch.float32).view(12, 2)
    rows = tmesh.node_sharding(table, mesh).as_parameters()
    idx = np.array([9, 1, 11, 0, 2])                 # shard 1 owns none
    pick = tmesh.row_pick(idx, 4, mesh.devices)
    assert pick.local[1].numel() == 0 and pick.count == 5
    got = pick.take(rows)
    assert torch.equal(got, table[torch.as_tensor(idx)])
    got.sum().backward()
    want = torch.zeros(12, 2)
    want[torch.as_tensor(idx)] = 1
    assert torch.equal(torch.cat([p.grad for p in rows.parts]), want)
    empty = tmesh.row_pick(np.zeros(0, np.int64), 4, mesh.devices)
    got = empty.take(rows)
    assert got.shape == (0, 2) and got.grad_fn is not None
    with pytest.raises(ValueError, match="outside"):
        tmesh.row_pick([12], 4, mesh.devices)


def test_rows_on_the_wrong_device_raise():
    """No fallback: rows whose shard lies on another device than the
    mesh's raise, and so does a plain tensor where node-sharded rows
    belong."""
    src, dst, typ, slots = _graph(5)
    mesh = tmesh.make_mesh(devices=("cpu",) * 2)
    he = thalo.device_put_halo_edges(thalo.halo_partition_edges(
        src, dst, typ, N, slots, 2, pad_to_multiple=8, halo_multiple=4),
        mesh)
    w = torch.randn(slots, D, HL)
    x = torch.randn(2 * he.n_per, D)
    rows = tmesh.node_sharding(x, mesh)
    wrong = tmesh.NodeRows((rows.parts[0], rows.parts[1].to("meta")))
    with pytest.raises(ValueError, match="lie on meta"):
        thalo.halo_aggregate(wrong, w, he, mesh)
    with pytest.raises(ValueError, match="shards of rows"):
        thalo.halo_aggregate(tmesh.NodeRows(rows.parts[:1]), w, he, mesh)
    with pytest.raises(TypeError, match="node-sharded rows"):
        thalo.halo_aggregate(x, w, he, mesh)
    layer = RGCNLayer(w, torch.randn(D, HL), torch.zeros(HL))
    with pytest.raises(TypeError, match="node-sharded rows"):
        thalo.halo_rgcn_conv(x, he, layer, mesh)


def test_replicate_adds_cotangents_in_its_order():
    """``replicate``: one alias per entry on the tensor's device, the
    cotangents added in the order given (a float sum whose value depends
    on it), and the groups a run of entries on one other device forms."""
    t = torch.tensor([1.0], requires_grad=True)
    cpu = torch.device("cpu")
    big, small = torch.tensor([1e8]), torch.tensor([1.0])
    for order, want in (([0, 1, 2], (big + small) - big),
                        ([0, 2, 1], (big - big) + small)):
        t.grad = None
        outs = tmesh.replicate(t, (cpu,) * 3, order)
        torch.autograd.backward(outs, (big, small, -big))
        assert torch.equal(t.grad, want)
    meta = torch.device("meta")
    assert tmesh.replicate_groups((cpu, meta, meta, cpu, meta), cpu,
                                  [0, 1, 2, 3, 4]) == \
        ((0,), (1, 2), (3,), (4,))
    assert tmesh.replicate_groups((cpu, cpu), cpu, [1, 0]) == ((1,), (0,))


@pytest.fixture(scope="module")
def ckpt_graph():
    k = {"nodes": 97, "edges": 700, "rels": 3, "steps": 3, "labelled": 20,
         "bf16": False, "reorder": False}
    src, dst, typ, slots = mh.make_graph(k, 4)
    return k, src, dst, typ, slots


def test_multihost_checkpoint_is_the_node_major_table(ckpt_graph, tmp_path):
    """``multihost_sim``'s loop (the library exchange, 4 virtual shards)
    writes the checkpoint keys of the one-tensor layout, and bytes: the
    state (embedding and Adam's moments as ``[S * n_per, D]`` tables in
    shard order) equals, bit for bit, the same loop run with the
    embedding as one ``[S * n_per, D]`` Parameter split at the conv's
    edge; the file reads back with those bits."""
    from scaling_rgcn_training_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)

    k, src, dst, typ, slots = ckpt_graph
    mesh = tmesh.make_mesh(devices=("cpu",) * 4)
    host = mh.partition("halo", src, dst, typ, k["nodes"], slots, 4, None)
    edges, n_pad = mh.place("halo", host, mesh)
    widths = (D, HL, C)
    params = mh.make_params(n_pad, widths, slots)
    rows, targets = mh.labels(k["nodes"], C, k["labelled"])
    saved = {}

    def save(tag, arrays, sharded):
        saved[tag] = ({n: v.numpy().copy() for n, v in arrays.items()},
                      sharded)

    mh.train(mesh, edges, params, rows, targets, "library", False,
             k["steps"], save)
    final, sharded = saved["final"]
    assert sorted(sharded) == ["adam/emb/exp_avg", "adam/emb/exp_avg_sq",
                               "emb"]
    names = ["emb"] + [f"layer{i}/{n}" for i in range(2)
                       for n in ("weight", "root", "bias")]
    assert list(final) == names + [f"adam/{n}/{m}" for n in names
                                   for m in ("exp_avg", "exp_avg_sq")]
    assert np.array_equal(saved["step0"][0]["emb"], params[0])

    # the one-tensor layout: the same loop, one Parameter for the table
    emb = torch.nn.Parameter(torch.tensor(params[0]))
    layers = [RGCNLayer(*[torch.tensor(a) for a in layer])
              for layer in params[1]]
    leaves = [emb, *(p for l in layers for p in l.parameters())]
    opt = make_optimizer(leaves, mh.LR, weight_decay=0.0)
    idx, y = torch.as_tensor(rows), torch.as_tensor(targets)
    for _ in range(k["steps"]):
        opt.zero_grad(set_to_none=True)
        z = thalo.halo_rgcn_conv(tmesh.shard_rows(emb, mesh), edges,
                                 layers[0], mesh).map(torch.relu)
        logits = thalo.halo_rgcn_conv(z, edges, layers[1], mesh).gather()
        part = F.binary_cross_entropy_with_logits(
            logits.index_select(0, idx), y, reduction="sum")
        (part / targets.size).backward()
        opt.step()
    want = {"emb": emb}
    for i, layer in enumerate(layers):
        for n, p in layer.named_parameters():
            want[f"layer{i}/{n}"] = p
    for n, p in list(want.items()):
        for m in ("exp_avg", "exp_avg_sq"):
            want[f"adam/{n}/{m}"] = opt.state[p][m]
    for n, v in want.items():
        assert np.array_equal(final[n], v.detach().numpy()), n
    path = save_checkpoint(str(tmp_path / "state"), {
        n: torch.tensor(v) for n, v in final.items()})
    back, _ = load_checkpoint(path)
    assert all(np.array_equal(back[n], v) for n, v in final.items())
