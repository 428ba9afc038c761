"""RegNet's X block (counterpart of cvnets_tpu/modules/regnet_modules.py:16-56):
1×1 → grouped 3×3 (the stride) → [SE] → 1×1 with its activation, a strided
1×1 ``down`` projection where the shapes change, stochastic depth, and the
model's activation on the sum."""

from __future__ import annotations

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.random_layers import StochasticDepth
from cvnets_tpu_torch.modules.squeeze_excitation import SqueezeExcitation


class XRegNetBlock(nn.Module):
    def __init__(self, opts, in_channels: int, out_channels: int, stride: int = 1,
                 group_width: int = 1, bottleneck_multiplier: float = 1.0,
                 se_ratio: float = 0.0, stochastic_depth_prob: float = 0.0) -> None:
        super().__init__()
        bottleneck = int(round(out_channels * bottleneck_multiplier))
        n_groups = max(1, bottleneck // max(1, group_width))
        self.conv1 = ConvLayer2d(opts, in_channels, bottleneck, 1)
        self.conv2 = ConvLayer2d(opts, bottleneck, bottleneck, 3, stride=stride,
                                 groups=n_groups)
        # the SE width follows the block's input width (regnet_modules.py:37-41)
        self.se = (SqueezeExcitation(opts, bottleneck,
                                     squeeze_channels=max(1, int(round(se_ratio * in_channels))),
                                     scale_fn_name="sigmoid") if se_ratio > 0 else None)
        self.conv3 = ConvLayer2d(opts, bottleneck, out_channels, 1)  # keeps its activation
        self.down = (ConvLayer2d(opts, in_channels, out_channels, kernel_size=1,
                                 stride=stride, use_act=False)
                     if stride != 1 or in_channels != out_channels else None)
        self.stochastic_depth = (StochasticDepth(stochastic_depth_prob)
                                 if stochastic_depth_prob > 0 else None)
        self.act = build_act_layer(opts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.se is not None:
            y = self.se(y)
        y = self.conv3(y)
        if self.down is not None:
            x = self.down(x)
        if self.stochastic_depth is not None:
            y = self.stochastic_depth(y)
        return self.act(x + y)
