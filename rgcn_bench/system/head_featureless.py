"""The port's featureless model (``models/heads.py``
``FeaturelessModel``): no front, the trunk's layers alone."""

from __future__ import annotations

from typing import Dict, List

import torch


def model(params: Dict[str, torch.Tensor],
          layers: List[torch.nn.Module]) -> torch.nn.Module:
    from scaling_rgcn_training_tpu_torch.models.heads import FeaturelessModel

    return FeaturelessModel(*layers)
