"""ASPP (counterpart of cvnets_tpu/modules/aspp_block.py): a 1×1 branch, one
dilated 3×3 branch per atrous rate and a global-pool branch, concatenated along
channels, projected by a 1×1 conv, then dropout. Used by DeepLabv3. Submodules
carry the flax scope names."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d


class ASPP(nn.Module):
    def __init__(self, opts, in_channels: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (6, 12, 18), is_sep_conv: bool = False,
                 dropout: float = 0.0) -> None:
        super().__init__()
        if is_sep_conv:
            raise NotImplementedError(
                "--model.segmentation.deeplabv3.aspp-sep-conv (SeparableConv2d branches, "
                "cvnets_tpu/modules/aspp_block.py:32-36) is not ported yet")
        self.conv_1x1 = ConvLayer2d(opts, in_channels, out_channels, kernel_size=1)
        self.n_rates = len(atrous_rates)
        for i, rate in enumerate(atrous_rates):
            self.add_module(f"aspp_rate_{i}", ConvLayer2d(
                opts, in_channels, out_channels, kernel_size=3, dilation=rate))
        self.aspp_pool = ConvLayer2d(opts, in_channels, out_channels, kernel_size=1)
        self.project = ConvLayer2d(opts, out_channels * (self.n_rates + 2), out_channels,
                                   kernel_size=1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.conv_1x1(x)]
        branches += [getattr(self, f"aspp_rate_{i}")(x) for i in range(self.n_rates)]
        pooled = self.aspp_pool(x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand_as(branches[0]))
        return self.dropout(self.project(torch.cat(branches, dim=1)))
