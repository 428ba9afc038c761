"""SSD prediction head (counterpart of cvnets_tpu/modules/ssd_heads.py:18-55):
an optional 1×1 projection (``proj_layer``), then a separable k×k conv, or a
1×1 conv where k is 1, to ``n_anchors · (4 + n_classes)`` channels, split into
box offsets and class scores. ``SSDInstanceHead`` waits with Mask R-CNN
(ROADMAP.md queue 1 item 10)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d, SeparableConv2d


class SSDHead(nn.Module):
    def __init__(self, opts, in_channels: int, n_classes: int, n_anchors: int,
                 proj_channels: int = -1, kernel_size: int = 3) -> None:
        super().__init__()
        self.n_classes = n_classes
        self.proj_layer = None
        if proj_channels > 0 and proj_channels != in_channels and kernel_size > 1:
            self.proj_layer = ConvLayer2d(opts, in_channels, proj_channels, 1)
            in_channels = proj_channels
        out_ch = n_anchors * (4 + n_classes)
        if kernel_size > 1:
            self.loc_cls_layer = SeparableConv2d(opts, in_channels, out_ch, kernel_size,
                                                 use_norm=False, use_act=False, bias=True)
        else:
            self.loc_cls_layer = ConvLayer2d(opts, in_channels, out_ch, 1, bias=True,
                                             use_norm=False, use_act=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(boxes (B, H·W·A, 4), scores (B, H·W·A, n_classes)), anchors in the
        JAX package's (h, w, anchor) order."""
        if self.proj_layer is not None:
            x = self.proj_layer(x)
        y = self.loc_cls_layer(x).permute(0, 2, 3, 1)
        y = y.reshape(y.shape[0], -1, 4 + self.n_classes)
        return y[..., :4], y[..., 4:]
