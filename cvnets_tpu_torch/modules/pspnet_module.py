"""Pyramid pooling (counterpart of cvnets_tpu/modules/pspnet_module.py): the
input, and for each pool size an adaptive average pool, a 1×1 conv to
in / len(pool sizes) channels and a bilinear upsampling back with
``jax.image.resize``'s weights, concatenated; then a 3×3 ``fusion`` conv and
dropout. Used by PSPNet. Submodules carry the flax scope names."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.pool import adaptive_avg_pool_2d
from cvnets_tpu_torch.ops.seg_ce import resize_bilinear


class PSP(nn.Module):
    def __init__(self, opts, in_channels: int, out_channels: int = 512,
                 pool_sizes: Sequence[int] = (1, 2, 3, 6), dropout: float = 0.1) -> None:
        super().__init__()
        self.pool_sizes = tuple(pool_sizes)
        reduction = max(1, in_channels // len(self.pool_sizes))
        for i in range(len(self.pool_sizes)):
            self.add_module(f"psp_branch_{i}",
                            ConvLayer2d(opts, in_channels, reduction, kernel_size=1))
        self.fusion = ConvLayer2d(opts, in_channels + reduction * len(self.pool_sizes),
                                  out_channels, kernel_size=3)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = tuple(x.shape[-2:])
        branches = [x]
        for i, ps in enumerate(self.pool_sizes):
            b = getattr(self, f"psp_branch_{i}")(adaptive_avg_pool_2d(x, (ps, ps)))
            branches.append(resize_bilinear(b, size))
        return self.dropout(self.fusion(torch.cat(branches, dim=1)))
