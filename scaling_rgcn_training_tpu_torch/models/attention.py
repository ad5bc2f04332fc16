"""Multi-head self-attention over stacked summary embeddings.

Counterpart of the JAX package's ``models/attention.py`` (reference
``nn.MultiheadAttention(embed_dim=d, num_heads=K, dropout=0.2)``,
model/layers.py:53,59-66): the stacked ``[K, N, d]`` embeddings are the
input, the K summaries the sequence axis and the N nodes the batch axis.
torch's MHA math (in-projection, scaled dot product per head, dropout on
the attention weights, out-projection) in plain tensor ops, with torch's
own parameter layouts (in-projection ``[3d, d]``, out-projection
``[d, d]``). The dropout mask is drawn from an explicit
``torch.Generator``, not the global generator.

The attention model's trunk reads only the first summary's output row:
:func:`mha_first_query` gives that row. On a card, for float32 inputs with
at most 8 summaries and heads, ``d <= 128`` and ``d % heads == 0``
(``ops/attention_kernels.py`` ``fused_ok``), it runs the fused CUDA
forward and backward of ``ops/attention_kernels.py``
(``csrc/attention_kernels.cu``), which compute that row alone; anything
else (the CPU, other dtypes, wider shapes) takes the plain-op route,
``mha_self_attention(...)[0]``. The recorder's counters ``att.fused`` and
``att.plain`` (``utils/tracing.py``) count the calls of each route. The
JAX package has no kernel for its MHA.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from scaling_rgcn_training_tpu_torch.ops.attention_kernels import (
    FirstQuery, fused_ok)
from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import uniform
from scaling_rgcn_training_tpu_torch.utils import tracing


class MHA(nn.Module):
    """``in_proj_w [3d, d]``, ``in_proj_b [3d]``, ``out_proj_w [d, d]``,
    ``out_proj_b [d]`` (torch ``MultiheadAttention`` layouts)."""

    def __init__(self, in_proj_w: torch.Tensor, in_proj_b: torch.Tensor,
                 out_proj_w: torch.Tensor, out_proj_b: torch.Tensor):
        super().__init__()
        self.in_proj_w = nn.Parameter(in_proj_w)
        self.in_proj_b = nn.Parameter(in_proj_b)
        self.out_proj_w = nn.Parameter(out_proj_w)
        self.out_proj_b = nn.Parameter(out_proj_b)


def init_mha(gen: torch.Generator, embed_dim: int) -> MHA:
    """torch ``MultiheadAttention._reset_parameters`` distributions:
    xavier-uniform in-projection, zero biases, Linear-default out-projection
    weight."""
    d = embed_dim
    return MHA(uniform(gen, (3 * d, d), float(np.sqrt(6.0 / (4 * d)))),
               torch.zeros(3 * d),
               uniform(gen, (d, d), 1.0 / float(np.sqrt(d))),
               torch.zeros(d))


def mha_self_attention(att: MHA, x: torch.Tensor, num_heads: int,
                       dropout_rate: float = 0.0,
                       gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Self-attention of ``x [L, B, d]`` (L summaries, B nodes) ->
    ``[L, B, d]``. With ``dropout_rate > 0`` and a generator (on ``x``'s
    device), each attention weight is kept with probability
    ``1 - dropout_rate`` and scaled by its inverse."""
    L, B, d = x.shape
    dh = d // num_heads
    if dh * num_heads != d:
        raise ValueError(f"embed_dim {d} is not divisible by num_heads "
                         f"{num_heads}")
    qkv = x @ att.in_proj_w.T + att.in_proj_b            # [L, B, 3d]
    # -> [B, H, L, dh]
    q, k, v = (t.reshape(L, B, num_heads, dh).permute(1, 2, 0, 3)
               for t in qkv.split(d, dim=-1))
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
    if dropout_rate > 0.0 and gen is not None:
        keep = torch.rand(attn.shape, generator=gen,
                          device=attn.device) >= dropout_rate
        attn = torch.where(keep, attn / (1.0 - dropout_rate),
                           torch.zeros((), dtype=attn.dtype,
                                       device=attn.device))
    out = (attn @ v).permute(2, 0, 1, 3).reshape(L, B, d)   # [L, B, d]
    return out @ att.out_proj_w.T + att.out_proj_b


def mha_first_query(att: MHA, x: torch.Tensor, num_heads: int,
                    dropout_rate: float = 0.0,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """``mha_self_attention(att, x, num_heads, dropout_rate, gen)[0]``:
    the first summary's row ``[B, d]``. Where :func:`fused_ok` takes the
    inputs, the fused kernels compute it (counter ``att.fused``; a strided
    input is made contiguous first), reading the same ``[B, H, L, L]``
    dropout draw from ``gen``; else the plain-op route (``att.plain``)."""
    L, B, d = x.shape
    params = (att.in_proj_w, att.in_proj_b, att.out_proj_w, att.out_proj_b)
    if not fused_ok(x, num_heads, *params):
        tracing.count("att.plain")
        return mha_self_attention(att, x, num_heads, dropout_rate, gen)[0]
    tracing.count("att.fused")
    draw = None
    if dropout_rate > 0.0 and gen is not None:
        draw = torch.rand((B, num_heads, L, L), generator=gen,
                          device=x.device)
    return FirstQuery.apply(x.contiguous(),
                            *(p.contiguous() for p in params), draw,
                            dropout_rate, num_heads)
