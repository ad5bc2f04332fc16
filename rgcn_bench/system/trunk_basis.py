"""The port's basis trunk over the run's initial parameters: an
``ops/rgcn_conv.py`` ``BasisLayer`` over the node id (bases ``[N, B,
hidden]``), then an ``RGCNLayer`` with ``comp`` (bases ``[B, hidden, C]``),
each in the reference's layout and under its leaf names."""

from __future__ import annotations

from typing import Dict, List

import torch


def layers(params: Dict[str, torch.Tensor]) -> List[torch.nn.Module]:
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
        BasisLayer, RGCNLayer)

    return [BasisLayer(*(params[f"rgcn1.{k}"]
                         for k in ("bases", "comp", "root", "bias"))),
            RGCNLayer(*(params[f"rgcn2.{k}"]
                        for k in ("weight", "root", "bias", "comp")))]
