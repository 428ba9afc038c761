"""ResNet blocks (counterpart of cvnets_tpu/modules/resnet_modules.py): the basic
block (two 3×3 convs) and the bottleneck (1×1, 3×3, 1×1), each with optional
dropout and squeeze-excitation on the residual branch, a strided 1×1 ``down``
projection where the shapes change, stochastic depth, then the model's
activation on the sum."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.random_layers import StochasticDepth
from cvnets_tpu_torch.modules.squeeze_excitation import SqueezeExcitation


class _ResNetBlock(nn.Module):
    """What both blocks share after their convs (resnet_modules.py:30-48)."""

    def _tail(self, opts, in_channels: int, out_channels: int, stride: int,
              squeeze_channels: Optional[int], stochastic_depth_prob: float,
              dropout: float) -> None:
        self.dropout = nn.Dropout(dropout) if 0.0 < dropout < 1.0 else None
        self.se = (SqueezeExcitation(opts, out_channels, squeeze_channels=squeeze_channels,
                                     scale_fn_name="sigmoid") if squeeze_channels else None)
        self.down = (ConvLayer2d(opts, in_channels, out_channels, kernel_size=1,
                                 stride=stride, use_act=False)
                     if stride != 1 or in_channels != out_channels else None)
        self.stochastic_depth = (StochasticDepth(stochastic_depth_prob)
                                 if stochastic_depth_prob > 0 else None)
        self.act = build_act_layer(opts)

    def _residual(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.dropout is not None:
            y = self.dropout(y)
        if self.se is not None:
            y = self.se(y)
        if self.down is not None:
            x = self.down(x)
        if self.stochastic_depth is not None:
            y = self.stochastic_depth(y)
        return self.act(x + y)


class BasicResNetBlock(_ResNetBlock):
    def __init__(self, opts, in_channels: int, mid_channels: int, out_channels: int,
                 stride: int = 1, dilation: int = 1, squeeze_channels: Optional[int] = None,
                 stochastic_depth_prob: float = 0.0, dropout: float = 0.0) -> None:
        super().__init__()
        self.conv1 = ConvLayer2d(opts, in_channels, mid_channels, 3, stride=stride,
                                 dilation=dilation)
        self.conv2 = ConvLayer2d(opts, mid_channels, out_channels, 3, dilation=dilation,
                                 use_act=False)
        self._tail(opts, in_channels, out_channels, stride, squeeze_channels,
                   stochastic_depth_prob, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._residual(x, self.conv2(self.conv1(x)))


class BottleneckResNetBlock(_ResNetBlock):
    def __init__(self, opts, in_channels: int, mid_channels: int, out_channels: int,
                 stride: int = 1, dilation: int = 1, squeeze_channels: Optional[int] = None,
                 stochastic_depth_prob: float = 0.0, dropout: float = 0.0) -> None:
        super().__init__()
        self.conv1 = ConvLayer2d(opts, in_channels, mid_channels, 1)
        self.conv2 = ConvLayer2d(opts, mid_channels, mid_channels, 3, stride=stride,
                                 dilation=dilation)
        self.conv3 = ConvLayer2d(opts, mid_channels, out_channels, 1, use_act=False)
        self._tail(opts, in_channels, out_channels, stride, squeeze_channels,
                   stochastic_depth_prob, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._residual(x, self.conv3(self.conv2(self.conv1(x))))
