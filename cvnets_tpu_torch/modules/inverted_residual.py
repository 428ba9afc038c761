"""MobileNetV2 inverted residual (counterpart of
cvnets_tpu/modules/inverted_residual.py:20-53): expand 1×1 → depthwise 3×3 →
project 1×1, plus the skip when shapes allow."""

from __future__ import annotations

import torch
import torch.nn as nn

from cvnets_tpu_torch.utils.math_utils import make_divisible
from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d


class InvertedResidual(nn.Module):
    def __init__(self, opts, in_channels: int, out_channels: int, stride: int = 1,
                 expand_ratio: float = 6.0, dilation: int = 1,
                 skip_connection: bool = True) -> None:
        super().__init__()
        hidden_dim = make_divisible(round(in_channels * expand_ratio), 8)
        self.use_res = stride == 1 and in_channels == out_channels and skip_connection
        self.exp_1x1 = (ConvLayer2d(opts, in_channels, hidden_dim, kernel_size=1)
                        if expand_ratio != 1 else None)
        self.conv_3x3 = ConvLayer2d(opts, hidden_dim, hidden_dim, kernel_size=3,
                                    stride=stride, dilation=dilation,
                                    groups=hidden_dim)
        self.red_1x1 = ConvLayer2d(opts, hidden_dim, out_channels, kernel_size=1,
                                   use_act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.exp_1x1(x) if self.exp_1x1 is not None else x
        y = self.red_1x1(self.conv_3x3(y))
        return x + y if self.use_res else y
