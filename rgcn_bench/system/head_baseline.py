"""The port's baseline model (``models/heads.py`` ``EmbModel``) over the
run's initial parameters and the trunk's layers."""

from __future__ import annotations

from typing import Dict, List

import torch


def model(params: Dict[str, torch.Tensor],
          layers: List[torch.nn.Module]) -> torch.nn.Module:
    from scaling_rgcn_training_tpu_torch.models.heads import EmbModel

    return EmbModel(params["embedding"], *layers)
