"""Squeeze-and-excitation (counterpart of cvnets_tpu/modules/squeeze_excitation.py:16-43):
global mean → 1×1 conv ``fc1`` + activation → 1×1 conv ``fc2`` + scale
function, times the input."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.utils.math_utils import make_divisible


class SqueezeExcitation(nn.Module):
    """``squeeze_channels`` defaults to ``max(make_divisible(C // squeeze_factor,
    8), 32)``; ``act_name`` None is the model's activation; the scale function
    is ``sigmoid`` (``hard_sigmoid`` in MobileNetV3)."""

    def __init__(self, opts, in_channels: int, squeeze_factor: int = 4,
                 squeeze_channels: Optional[int] = None, scale_fn_name: str = "sigmoid",
                 act_name: Optional[str] = None) -> None:
        super().__init__()
        if squeeze_channels is None:
            squeeze_channels = max(make_divisible(in_channels // squeeze_factor, 8), 32)
        self.fc1 = nn.Conv2d(in_channels, squeeze_channels, 1, bias=True)
        self.act = build_act_layer(opts, act_name)
        self.fc2 = nn.Conv2d(squeeze_channels, in_channels, 1, bias=True)
        self.scale_fn = build_act_layer(opts, scale_fn_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * self.scale_fn(self.fc2(self.act(self.fc1(s))))
