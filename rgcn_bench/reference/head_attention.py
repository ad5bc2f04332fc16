"""The attention head, the reference's ``Emb_ATT_Layers``: self-attention
of ``torch.nn.MultiheadAttention(d, num_heads=L, dropout)`` over the L
stacked summary embeddings ``[L, N, d]`` (the summaries the sequence, the
nodes the batch), written out: the packed in-projection ``[3d, d]``,
scaled dot products per head, softmax, dropout on the attention weights
(kept with probability ``1 - p``, scaled by its inverse), the
out-projection; ``attn_output[0]`` feeds the trunk. The embedding is
frozen (transferred; here drawn U[0, 1))."""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from rgcn_bench.reference import rgcn

# the packed in-projection holds three projections; each is a leaf of its
# own in the comparison (the key bias has no gradient under softmax)
SPLITS = {"att.in_proj_w": ("q", "k", "v"), "att.in_proj_b": ("q", "k", "v")}


def init_params(config: Dict[str, Any], gen: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """The stacked embedding U[0, 1), torch's MHA initialisation
    (xavier-uniform in-projection, zero biases, Linear-default
    out-projection weight) and the trunk."""
    seq, n, d = config["num_sums"], config["num_entities"], config["emb_dim"]
    params = {
        "embedding": torch.rand((seq, n, d), generator=gen, device=device),
        "att.in_proj_w": rgcn.uniform((3 * d, d), math.sqrt(6 / (4 * d)),
                                      gen, device),
        "att.in_proj_b": torch.zeros(3 * d, device=device),
        "att.out_proj_w": rgcn.uniform((d, d), 1 / math.sqrt(d), gen, device),
        "att.out_proj_b": torch.zeros(d, device=device)}
    trunk = rgcn.trunk_module(config)
    params.update(trunk.init_params(config, gen, device))
    return params


def mask_shape(config: Dict[str, Any]):
    """The shape of one step's dropout draw: ``[N, heads, L, L]``."""
    seq = config["num_sums"]
    return (config["num_entities"], config["attention_heads"], seq, seq)


def front(params, config, precision, dropout_masks=None) -> torch.Tensor:
    x = params["embedding"]
    seq, n, d = x.shape
    heads = config["attention_heads"]
    dh = d // heads
    w, b = params["att.in_proj_w"], params["att.in_proj_b"]
    rows = x.reshape(seq * n, d)

    def project(i):
        y = rgcn.product(rows, w[i * d:(i + 1) * d].T, precision) + \
            b[i * d:(i + 1) * d]
        return y.reshape(seq, n, heads, dh).permute(1, 2, 0, 3)

    q, k, v = project(0), project(1), project(2)            # [N, H, L, dh]
    scores = rgcn.product(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
    attn = torch.softmax(scores, dim=-1)
    if dropout_masks is not None:
        p = config["dropout"]
        keep = dropout_masks(mask_shape(config))
        attn = torch.where(keep, attn / (1.0 - p), torch.zeros_like(attn))
    out = rgcn.product(attn, v, precision)                  # [N, H, L, dh]
    out = out.permute(2, 0, 1, 3).reshape(seq * n, d)
    y = rgcn.product(out, params["att.out_proj_w"].T, precision) + \
        params["att.out_proj_b"]
    return y.reshape(seq, n, d)[0]


def flops(config: Dict[str, Any], n: int) -> Tuple[int, int]:
    """``(forward, backward)`` FLOPs of the head over ``n`` nodes: its
    in-projection, the two batched attention products and the
    out-projection of all ``L`` summaries; in the backward their weight
    gradients and every input gradient but the frozen embedding's."""
    seq, d, heads = config["num_sums"], config["emb_dim"], \
        config["attention_heads"]
    dh = d // heads
    proj_in = 2 * seq * n * d * 3 * d
    scores = n * heads * 2 * seq * dh * seq
    proj_out = 2 * seq * n * d * d
    return (proj_in + 2 * scores + proj_out,
            proj_in + 4 * scores + 2 * proj_out)


def param_elements(config: Dict[str, Any], n: int) -> Dict[str, int]:
    """The head's parameter elements by top-level name: the stacked
    embedding and the attention's projections with their biases."""
    seq, d = config["num_sums"], config["emb_dim"]
    return {"embedding": seq * n * d, "att": 4 * d * d + 4 * d}
