"""The port's attention model (``models/heads.py`` ``ATTModel`` over
``models/attention.py`` ``MHA``) over the run's initial parameters and the
trunk's layers."""

from __future__ import annotations

from typing import Dict, List

import torch


def model(params: Dict[str, torch.Tensor],
          layers: List[torch.nn.Module]) -> torch.nn.Module:
    from scaling_rgcn_training_tpu_torch.models.attention import MHA
    from scaling_rgcn_training_tpu_torch.models.heads import ATTModel

    att = MHA(*(params[f"att.{k}"] for k in ("in_proj_w", "in_proj_b",
                                            "out_proj_w", "out_proj_b")))
    return ATTModel(params["embedding"], att, *layers)
