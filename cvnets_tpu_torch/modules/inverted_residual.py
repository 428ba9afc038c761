"""Inverted residual blocks (counterpart of cvnets_tpu/modules/inverted_residual.py):
``InvertedResidual`` is MobileNetV2's expand 1×1 → depthwise 3×3 → project 1×1,
plus the skip when shapes allow; ``InvertedResidualSE`` (MobileNetV3,
EfficientNet) takes a k×k depthwise conv, squeeze-excitation before the
projection, and stochastic depth on the residual branch."""

from __future__ import annotations

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.random_layers import StochasticDepth
from cvnets_tpu_torch.modules.squeeze_excitation import SqueezeExcitation
from cvnets_tpu_torch.utils.math_utils import make_divisible


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


class InvertedResidualSE(nn.Module):
    """``use_hs`` takes hard-swish for ``act_fn_name``; the SE block squeezes
    the hidden width by ``squeeze_factor`` and scales by ``se_scale_fn_name``
    (inverted_residual.py:56-108)."""

    def __init__(self, opts, in_channels: int, out_channels: int, expand_ratio: float,
                 use_hs: bool = False, use_se: bool = False, stride: int = 1,
                 kernel_size: int = 3, dilation: int = 1, squeeze_factor: int = 4,
                 stochastic_depth_prob: float = 0.0, se_scale_fn_name: str = "hard_sigmoid",
                 act_fn_name: str = "relu") -> None:
        super().__init__()
        act_name = "hard_swish" if use_hs else act_fn_name
        hidden_dim = make_divisible(round(in_channels * expand_ratio), 8)
        self.use_res = stride == 1 and in_channels == out_channels
        self.exp_1x1 = (ConvLayer2d(opts, in_channels, hidden_dim, kernel_size=1,
                                    act_name=act_name) if expand_ratio != 1 else None)
        self.conv_kxk = ConvLayer2d(opts, hidden_dim, hidden_dim, kernel_size=kernel_size,
                                    stride=stride, dilation=dilation, groups=hidden_dim,
                                    act_name=act_name)
        self.se = (SqueezeExcitation(opts, hidden_dim, squeeze_factor=squeeze_factor,
                                     scale_fn_name=se_scale_fn_name) if use_se else None)
        self.red_1x1 = ConvLayer2d(opts, hidden_dim, out_channels, kernel_size=1,
                                   use_act=False)
        self.stochastic_depth = (StochasticDepth(stochastic_depth_prob)
                                 if self.use_res and stochastic_depth_prob > 0 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.exp_1x1(x) if self.exp_1x1 is not None else x
        y = self.conv_kxk(y)
        if self.se is not None:
            y = self.se(y)
        y = self.red_1x1(y)
        if not self.use_res:
            return y
        if self.stochastic_depth is not None:
            y = self.stochastic_depth(y)
        return x + y
