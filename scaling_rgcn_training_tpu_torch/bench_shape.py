"""The bench shape of the port's card runs (``chip_smoke.py``,
``profile_step.py`` and ``bwd_variants.py``): the JAX package's
``bench.py`` graph size, uniform random edges from seed 0, a labelled split
and the baseline embedding model's trainer; and the AM shape's constants
(``rehearse_am.py``, ``rehearse_am_dist.py``). Nothing here measures; the
tools build their runs from it, so their numbers are taken on the same
graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# nodes, edges, relations, embedding, hidden and class widths (bench.py);
# 2 * R + 1 relation slots (inverse relations and the self loop)
N, E, R, D, HL, C = 200_000, 4_000_000, 45, 64, 16, 8
SLOTS = 2 * R + 1
N_TRAIN, N_VAL = 4096, 1024
# summary graphs whose embeddings the MLP and attention heads take
NUM_SUMS = 4
# the AM shape (the JAX package's scripts/rehearse_am.py:38-43,67): the
# reference's largest dataset, 133 relations (2 * R + 1 = 267 slots),
# 64 -> 16 -> 11, 8,192 labelled rows; rehearse_am.py and
# rehearse_am_dist.py draw its graph
AM_N, AM_E, AM_R, AM_D, AM_HL, AM_C = 1_600_000, 12_000_000, 133, 64, 16, 11
AM_LABELLED = 8192


def bench_edges(seed: int = 0, n: Optional[int] = None,
                e: Optional[int] = None, slots: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(src, dst, type)`` int32 ``[e]``, uniform over ``n`` nodes and
    ``slots`` relation slots (the bench shape's by default)."""
    n, e, slots = n or N, e or E, slots or SLOTS
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    typ = rng.integers(0, slots, e).astype(np.int32)
    return src, dst, typ


def bench_splits(device) -> Dict[str, torch.Tensor]:
    """``N_TRAIN`` training and ``N_VAL`` validation nodes drawn without
    replacement (seed 1), with one-hot labels cycling over the classes:
    the split keywords of ``DeviceGraph``."""
    labelled = np.random.default_rng(1).choice(N, N_TRAIN + N_VAL,
                                               replace=False)
    onehot = np.eye(C, dtype=np.float32)
    t = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype).to(device)
    return dict(x_train=t(labelled[:N_TRAIN], torch.int64),
                y_train=t(onehot[np.arange(N_TRAIN) % C]),
                x_val=t(labelled[N_TRAIN:], torch.int64),
                y_val=t(onehot[np.arange(N_VAL) % C]))


def bench_trainer(epochs: int, device, compute_dtype=None,
                  head: str = "summation", seed: int = 0, **trainer_kw):
    """``(Trainer, model)`` of the bench shape from the parameters of
    ``seed`` (the Trainer's);
    ``trainer_kw`` (``backend``, ``aggr``, ``mesh``, ``partition``) go to
    the Trainer. ``head`` ``"mlp"`` or ``"attention"`` takes ``NUM_SUMS``
    transferred embeddings (U[0, 1) draws in the transfer's shapes:
    ``[N, NUM_SUMS * D]`` concatenated, ``[NUM_SUMS, N, D]`` stacked, so
    the attention head has ``NUM_SUMS`` heads of ``D / NUM_SUMS``)."""
    from torch import nn

    from scaling_rgcn_training_tpu_torch.models.heads import HEADS
    from scaling_rgcn_training_tpu_torch.train.trainer import Trainer

    trainer = Trainer(None, HL, epochs, D, lr=0.01, weight_d=5e-5, seed=seed,
                      device=device, compute_dtype=compute_dtype, **trainer_kw)
    model = HEADS[head](trainer.gen, SLOTS, HL, C, N, D, num_sums=NUM_SUMS,
                        device=device)
    if head in ("mlp", "attention"):
        shape = (N, NUM_SUMS * D) if head == "mlp" else (NUM_SUMS, N, D)
        model.embedding = nn.Parameter(
            torch.rand(shape, generator=trainer.gen).to(device))
    return trainer, model
