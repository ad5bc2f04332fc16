"""The three model variants: summation/baseline, MLP and attention heads.

Counterpart of the JAX package's ``models/heads.py`` (reference
model/layers.py:11-130). Each model maps to logits ``[N, C]``; its
``forward`` takes ``train`` (dropout on) and a ``torch.Generator`` for the
dropout mask, as the JAX ``apply`` functions take ``train`` and ``rng``.

Shared trunk: front-end -> rgcn1 (d -> hidden) -> ReLU -> rgcn2
(hidden -> C). Front-ends:

- ``EmbModel`` (``Emb_Layers``, layers.py:11-46): the embedding ``[N, d]``;
- ``MLPModel`` (``Emb_MLP_Layers``, layers.py:90-130): ``tanh(lin1)`` then
  ``lin2`` back to ``d`` over the concatenated embeddings ``[N, K * d]``;
- ``ATTModel`` (``Emb_ATT_Layers``, layers.py:49-87): self-attention with
  K heads over the stacked embeddings ``[K, N, d]``, keeping
  ``attn_out[0]`` (``models/attention.py`` ``mha_first_query``, which
  computes that row alone on a card).

``FeaturelessModel`` has no front-end and no embedding: the R-GCN paper's
entity classifier (Schlichtkrull et al. 2018 §5.1; PyG ``RGCNConv`` with
``x=None``), whose rgcn1 reads the node id through basis weights
(``ops/rgcn_conv.py`` ``BasisLayer``, bases ``[N, B, hidden]``) and whose
rgcn2 is a basis-decomposed ``RGCNLayer``.

Linear weights keep torch's ``[out_features, in_features]`` layout, as the
JAX package does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from scaling_rgcn_training_tpu_torch.models.attention import (
    MHA, init_mha, mha_first_query)
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    BasisLayer, RelEdges, RGCNLayer, init_rgcn_layer, rgcn_conv, uniform)
from scaling_rgcn_training_tpu_torch.parallel.mesh import (
    Mesh, NodeRows, node_sharding)
from scaling_rgcn_training_tpu_torch.utils.tracing import grad_mark, mark

DROPOUT = 0.2


class _Trunk(nn.Module):
    """rgcn1 -> ReLU -> rgcn2 after the model's front-end."""

    def trunk(self, x: torch.Tensor, edges: RelEdges,
              compute_dtype: Optional[torch.dtype], backend: Optional[str],
              aggr: str) -> torch.Tensor:
        """``backend`` and ``aggr`` go to both convs, as the JAX package's
        ``_trunk`` passes them. Inside a train step the trunk is marked
        (``utils/tracing.py``): ``trunk.in`` and ``trunk.out`` around it,
        and ``trunk.grad`` when the backward reaches its input."""
        mark("trunk.in")
        x = grad_mark(x, "trunk.grad")
        x = rgcn_conv(x, edges, self.rgcn1, backend=backend,
                      compute_dtype=compute_dtype, aggr=aggr)
        x = torch.relu(x)
        x = rgcn_conv(x, edges, self.rgcn2, backend=backend,
                      compute_dtype=compute_dtype, aggr=aggr)
        mark("trunk.out")
        return x


class EmbModel(_Trunk):
    def __init__(self, embedding: torch.Tensor, rgcn1: RGCNLayer,
                 rgcn2: RGCNLayer):
        super().__init__()
        self.embedding = nn.Parameter(embedding)
        self.rgcn1 = rgcn1
        self.rgcn2 = rgcn2

    def forward(self, edges: RelEdges,
                compute_dtype: Optional[torch.dtype] = None,
                backend: Optional[str] = None, aggr: str = "mean",
                train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[N, C]``."""
        return self.trunk(self.embedding, edges, compute_dtype, backend, aggr)


class MLPModel(_Trunk):
    def __init__(self, embedding: torch.Tensor, lin1_w: torch.Tensor,
                 lin1_b: torch.Tensor, lin2_w: torch.Tensor,
                 lin2_b: torch.Tensor, rgcn1: RGCNLayer, rgcn2: RGCNLayer):
        super().__init__()
        self.embedding = nn.Parameter(embedding)
        self.lin1_w = nn.Parameter(lin1_w)
        self.lin1_b = nn.Parameter(lin1_b)
        self.lin2_w = nn.Parameter(lin2_w)
        self.lin2_b = nn.Parameter(lin2_b)
        self.rgcn1 = rgcn1
        self.rgcn2 = rgcn2

    def forward(self, edges: RelEdges,
                compute_dtype: Optional[torch.dtype] = None,
                backend: Optional[str] = None, aggr: str = "mean",
                train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.tanh(self.embedding @ self.lin1_w.T + self.lin1_b)
        x = x @ self.lin2_w.T + self.lin2_b
        return self.trunk(x, edges, compute_dtype, backend, aggr)


class ATTModel(_Trunk):
    def __init__(self, embedding: torch.Tensor, att: MHA, rgcn1: RGCNLayer,
                 rgcn2: RGCNLayer):
        super().__init__()
        self.embedding = nn.Parameter(embedding)
        self.att = att
        self.rgcn1 = rgcn1
        self.rgcn2 = rgcn2
        self.dropout = DROPOUT

    def forward(self, edges: RelEdges,
                compute_dtype: Optional[torch.dtype] = None,
                backend: Optional[str] = None, aggr: str = "mean",
                train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """With ``train``, dropout on the attention weights from ``gen``."""
        # the first "sequence" element: the fused node features
        fused = mha_first_query(
            self.att, self.embedding, num_heads=self.embedding.shape[0],
            dropout_rate=self.dropout if train else 0.0, gen=gen)
        return self.trunk(fused, edges, compute_dtype, backend, aggr)


class FeaturelessModel(nn.Module):
    """rgcn1, a featureless :class:`BasisLayer` over the node id (bases
    ``[N, B, hidden]``, root ``[N, hidden]``) -> ReLU -> rgcn2, an
    :class:`RGCNLayer` with ``comp`` (bases ``[B, hidden, C]``). Inside a
    train step it is marked (``utils/tracing.py``): ``trunk.in`` before
    rgcn1, ``basis.out`` after it, ``trunk.out`` after rgcn2; in the
    backward ``basis.grad`` when it reaches rgcn1's output and
    ``trunk.grad`` when rgcn1's backward ends (``ops/rgcn_conv.py``)."""

    def __init__(self, rgcn1: BasisLayer, rgcn2: RGCNLayer):
        super().__init__()
        self.rgcn1 = rgcn1
        self.rgcn2 = rgcn2

    def forward(self, edges: RelEdges,
                compute_dtype: Optional[torch.dtype] = None,
                backend: Optional[str] = None, aggr: str = "mean",
                train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[N, C]``."""
        mark("trunk.in")
        x = rgcn_conv(None, edges, self.rgcn1, backend=backend,
                      compute_dtype=compute_dtype, aggr=aggr)
        mark("basis.out")
        x = grad_mark(x, "basis.grad")
        x = rgcn_conv(torch.relu(x), edges, self.rgcn2, backend=backend,
                      compute_dtype=compute_dtype, aggr=aggr)
        mark("trunk.out")
        return x


def init_featureless_model(gen: torch.Generator, num_slots: int, hidden: int,
                           num_classes: int, num_nodes: int,
                           num_bases: int = 40,
                           device="cpu") -> FeaturelessModel:
    """Random model from ``gen`` as PyG ``RGCNConv.reset_parameters`` draws
    it, layer by layer: bases, comp and root glorot (U(+-sqrt(6 / (fan_in
    + fan_out))), the bases' fans ``in`` and ``out``), bias zeros; rgcn1's
    bases ``[N, num_bases, hidden]`` and root ``[N, hidden]``, rgcn2's
    ``[num_bases, hidden, C]`` and ``[hidden, C]``."""
    glorot = lambda shape, fans: uniform(gen, shape, float(np.sqrt(
        6.0 / fans)))
    comp = lambda: glorot((num_slots, num_bases), num_slots + num_bases)
    n, h, c = num_nodes, hidden, num_classes
    rgcn1 = BasisLayer(glorot((n, num_bases, h), n + h), comp(),
                       glorot((n, h), n + h), torch.zeros(h))
    weight, comp2 = glorot((num_bases, h, c), h + c), comp()
    rgcn2 = RGCNLayer(weight, glorot((h, c), h + c), torch.zeros(c), comp2)
    return FeaturelessModel(rgcn1, rgcn2).to(device)


def _init_trunk(gen, num_slots, emb_dim, hidden, num_classes, num_bases,
                num_blocks):
    return (init_rgcn_layer(gen, num_slots, emb_dim, hidden, num_bases,
                            num_blocks),
            init_rgcn_layer(gen, num_slots, hidden, num_classes, num_bases,
                            num_blocks))


def init_emb_model(gen: torch.Generator, num_slots: int, hidden: int,
                   num_classes: int, num_nodes: int, emb_dim: int,
                   num_sums: int = 1, num_bases: Optional[int] = None,
                   num_blocks: Optional[int] = None, device="cpu") -> EmbModel:
    """Random model from ``gen``: embedding N(0, 1) (torch ``nn.Embedding``
    default), layers as :func:`init_rgcn_layer`; ``num_sums`` is unused
    (one signature for every head)."""
    embedding = torch.randn((num_nodes, emb_dim), generator=gen)
    rgcn1, rgcn2 = _init_trunk(gen, num_slots, emb_dim, hidden, num_classes,
                               num_bases, num_blocks)
    return EmbModel(embedding, rgcn1, rgcn2).to(device)


def init_mlp_model(gen: torch.Generator, num_slots: int, hidden: int,
                   num_classes: int, num_nodes: int, emb_dim: int,
                   num_sums: int = 1, num_bases: Optional[int] = None,
                   num_blocks: Optional[int] = None, device="cpu") -> MLPModel:
    """``in_f = num_sums * emb_dim``, ``out_f = round(in_f * 2/3 + C)``
    (layers.py:93); linear weights kaiming-uniform over fan-in (bound
    ``sqrt(6 / fan_in)``, layers.py:101-102), biases torch Linear's default
    (``1 / sqrt(fan_in)``). The embedding is ``[N, emb_dim]`` until a
    transfer replaces it with the ``[N, in_f]`` concatenation."""
    in_f = num_sums * emb_dim
    out_f = round(in_f * (2.0 / 3.0) + num_classes)
    embedding = torch.randn((num_nodes, emb_dim), generator=gen)
    lin1_w = uniform(gen, (out_f, in_f), float(np.sqrt(6.0 / in_f)))
    lin1_b = uniform(gen, (out_f,), 1.0 / float(np.sqrt(in_f)))
    lin2_w = uniform(gen, (emb_dim, out_f), float(np.sqrt(6.0 / out_f)))
    lin2_b = uniform(gen, (emb_dim,), 1.0 / float(np.sqrt(out_f)))
    rgcn1, rgcn2 = _init_trunk(gen, num_slots, emb_dim, hidden, num_classes,
                               num_bases, num_blocks)
    return MLPModel(embedding, lin1_w, lin1_b, lin2_w, lin2_b, rgcn1,
                    rgcn2).to(device)


def init_att_model(gen: torch.Generator, num_slots: int, hidden: int,
                   num_classes: int, num_nodes: int, emb_dim: int,
                   num_sums: int = 1, num_bases: Optional[int] = None,
                   num_blocks: Optional[int] = None, device="cpu") -> ATTModel:
    """A stacked N(0, 1) embedding ``[num_sums, N, emb_dim]`` (the
    reference leaves it unset until a transfer, layers.py:55), attention as
    :func:`init_mha`."""
    embedding = torch.randn((num_sums, num_nodes, emb_dim), generator=gen)
    att = init_mha(gen, emb_dim)
    rgcn1, rgcn2 = _init_trunk(gen, num_slots, emb_dim, hidden, num_classes,
                               num_bases, num_blocks)
    return ATTModel(embedding, att, rgcn1, rgcn2).to(device)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def layer_from_numpy(leaves: Sequence[Optional[np.ndarray]]) -> RGCNLayer:
    weight, root, bias, *rest = leaves
    comp = rest[0] if rest else None
    return RGCNLayer(_t(weight), _t(root), _t(bias),
                     None if comp is None else _t(comp))


def node_rows_from_numpy(embedding: np.ndarray, mesh: Mesh) -> NodeRows:
    """A JAX node-sharded embedding ``[S * n_per, d]`` (``put_global(a,
    node_sharding(mesh))``), as numpy -> this process's shards on
    ``mesh``, one ``nn.Parameter`` a shard on its device
    (``parallel/mesh.py`` ``NodeRows``); ``.numpy()`` gives the array
    back."""
    return node_sharding(np.asarray(embedding, np.float32),
                         mesh).as_parameters()


def emb_model_from_numpy(embedding: np.ndarray,
                         rgcn1: Sequence[Optional[np.ndarray]],
                         rgcn2: Sequence[Optional[np.ndarray]],
                         device="cpu") -> EmbModel:
    """The port's model from the JAX ``EmbModelParams`` leaves as numpy:
    ``rgcn1``/``rgcn2`` are ``(weight, root, bias[, comp])``."""
    return EmbModel(_t(embedding), layer_from_numpy(rgcn1),
                    layer_from_numpy(rgcn2)).to(device)


def mlp_model_from_numpy(embedding: np.ndarray, lin1_w: np.ndarray,
                         lin1_b: np.ndarray, lin2_w: np.ndarray,
                         lin2_b: np.ndarray,
                         rgcn1: Sequence[Optional[np.ndarray]],
                         rgcn2: Sequence[Optional[np.ndarray]],
                         device="cpu") -> MLPModel:
    """The port's MLP model from the JAX ``MLPModelParams`` leaves."""
    return MLPModel(_t(embedding), _t(lin1_w), _t(lin1_b), _t(lin2_w),
                    _t(lin2_b), layer_from_numpy(rgcn1),
                    layer_from_numpy(rgcn2)).to(device)


def att_model_from_numpy(embedding: np.ndarray,
                         att: Sequence[np.ndarray],
                         rgcn1: Sequence[Optional[np.ndarray]],
                         rgcn2: Sequence[Optional[np.ndarray]],
                         device="cpu") -> ATTModel:
    """The port's attention model from the JAX ``ATTModelParams`` leaves:
    ``att`` is ``(in_proj_w, in_proj_b, out_proj_w, out_proj_b)``."""
    return ATTModel(_t(embedding), MHA(*(_t(a) for a in att)),
                    layer_from_numpy(rgcn1),
                    layer_from_numpy(rgcn2)).to(device)


HEADS = {
    "summation": init_emb_model,
    "baseline": init_emb_model,
    "mlp": init_mlp_model,
    "attention": init_att_model,
}
