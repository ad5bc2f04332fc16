"""The bench shape of the port's card runs (``chip_smoke.py`` and
``profile_step.py``): the JAX package's ``bench.py`` graph size, uniform
random edges from seed 0, a labelled split and the baseline embedding model's
trainer. Nothing here measures; both tools build their runs from it, so their
numbers are taken on the same graph.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# nodes, edges, relations, embedding, hidden and class widths (bench.py);
# 2 * R + 1 relation slots (inverse relations and the self loop)
N, E, R, D, HL, C = 200_000, 4_000_000, 45, 64, 16, 8
SLOTS = 2 * R + 1
N_TRAIN, N_VAL = 4096, 1024


def bench_edges(seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(src, dst, type)`` int32 ``[E]``, uniform over nodes and slots."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    typ = rng.integers(0, SLOTS, E).astype(np.int32)
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


def bench_trainer(epochs: int, device, compute_dtype=None, **trainer_kw):
    """``(Trainer, EmbModel)`` of the bench shape from the seed-0
    parameters; ``trainer_kw`` (``backend``, ``aggr``) go to the Trainer."""
    from scaling_rgcn_training_tpu_torch.models.heads import init_emb_model
    from scaling_rgcn_training_tpu_torch.train.trainer import Trainer

    trainer = Trainer(None, HL, epochs, D, lr=0.01, weight_d=5e-5, seed=0,
                      device=device, compute_dtype=compute_dtype, **trainer_kw)
    model = init_emb_model(trainer.gen, SLOTS, HL, C, N, D, device=device)
    return trainer, model
