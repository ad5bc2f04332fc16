"""The embedding model of the summation and baseline experiments.

Counterpart of the JAX package's ``models/heads.py`` ``EmbModelParams`` /
``apply_emb_model`` (reference ``Emb_Layers``, model/layers.py:11-46):
embedding ``[N, d]`` -> rgcn1 (d -> hidden) -> ReLU -> rgcn2 (hidden -> C),
emitting logits. The MLP and attention heads are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
    RGCNLayer, init_rgcn_layer, rgcn_conv)
from scaling_rgcn_training_tpu_torch.ops.span_kernels import SpanPlan


class EmbModel(nn.Module):
    def __init__(self, embedding: torch.Tensor, rgcn1: RGCNLayer,
                 rgcn2: RGCNLayer):
        super().__init__()
        self.embedding = nn.Parameter(embedding)
        self.rgcn1 = rgcn1
        self.rgcn2 = rgcn2

    def forward(self, edges: SpanPlan,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = rgcn_conv(self.embedding, edges, self.rgcn1, compute_dtype)
        x = torch.relu(x)
        return rgcn_conv(x, edges, self.rgcn2, compute_dtype)


def init_emb_model(gen: torch.Generator, num_slots: int, hidden: int,
                   num_classes: int, num_nodes: int, emb_dim: int,
                   num_bases: Optional[int] = None,
                   num_blocks: Optional[int] = None, device="cpu") -> EmbModel:
    """Random model from ``gen``: embedding N(0, 1) (torch ``nn.Embedding``
    default), layers as :func:`init_rgcn_layer`."""
    embedding = torch.randn((num_nodes, emb_dim), generator=gen)
    rgcn1 = init_rgcn_layer(gen, num_slots, emb_dim, hidden, num_bases,
                            num_blocks)
    rgcn2 = init_rgcn_layer(gen, num_slots, hidden, num_classes, num_bases,
                            num_blocks)
    return EmbModel(embedding, rgcn1, rgcn2).to(device)


def _layer_from_numpy(leaves: Sequence[Optional[np.ndarray]]) -> RGCNLayer:
    weight, root, bias, *rest = leaves
    comp = rest[0] if rest else None
    t = lambda a: None if a is None else torch.tensor(np.asarray(a, np.float32))
    return RGCNLayer(t(weight), t(root), t(bias), t(comp))


def emb_model_from_numpy(embedding: np.ndarray,
                         rgcn1: Sequence[Optional[np.ndarray]],
                         rgcn2: Sequence[Optional[np.ndarray]],
                         device="cpu") -> EmbModel:
    """The port's model from the JAX ``EmbModelParams`` leaves as numpy:
    ``rgcn1``/``rgcn2`` are ``(weight, root, bias[, comp])``."""
    return EmbModel(torch.tensor(np.asarray(embedding, np.float32)),
                    _layer_from_numpy(rgcn1),
                    _layer_from_numpy(rgcn2)).to(device)


HEADS = {
    "summation": init_emb_model,
    "baseline": init_emb_model,
}
