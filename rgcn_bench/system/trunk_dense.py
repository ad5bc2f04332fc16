"""The port's dense trunk: two ``ops/rgcn_conv.py`` ``RGCNLayer`` with
full relation weights, over the run's initial parameters.

Every ``trunk_<trunk>.py`` here gives ``layers(params)``: the port's conv
layers, in order, which the head's ``model`` puts behind its front."""

from __future__ import annotations

from typing import Dict, List

import torch


def layers(params: Dict[str, torch.Tensor]) -> List[torch.nn.Module]:
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import RGCNLayer

    return [RGCNLayer(params[f"{name}.weight"], params[f"{name}.root"],
                      params[f"{name}.bias"]) for name in ("rgcn1", "rgcn2")]
