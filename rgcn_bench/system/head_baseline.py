"""The port's baseline model (``models/heads.py`` ``EmbModel``) over the
run's initial parameters."""

from __future__ import annotations

from typing import Dict

import torch


def trunk_layer(params: Dict[str, torch.Tensor], name: str):
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer

    return RGCNLayer(params[f"{name}.weight"], params[f"{name}.root"],
                     params[f"{name}.bias"])


def model(params: Dict[str, torch.Tensor]) -> torch.nn.Module:
    from scaling_rgcn_training_tpu_torch.models.heads import EmbModel

    return EmbModel(params["embedding"], trunk_layer(params, "rgcn1"),
                    trunk_layer(params, "rgcn2"))
