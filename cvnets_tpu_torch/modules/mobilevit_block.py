"""MobileViTv2 block (counterpart of cvnets_tpu/modules/mobilevit_block.py:27-158).

The convs run NCHW; the attention runs on (B, P, N, C) patches, the JAX package's
layout. ``unfold_nchw``/``fold_nchw`` produce and consume exactly the patches of the
JAX ``unfold_nhwc``/``fold_nhwc`` (:27-43), as one reshape and permute each.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.normalization import get_normalization_layer
from cvnets_tpu_torch.modules.transformer import LinearAttnFFN


def unfold_nchw(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, P=ph*pw, N=(H/ph)*(W/pw), C); H and W must divide."""
    b, c, h, w = x.shape
    nh, nw = h // ph, w // pw
    x = x.reshape(b, c, nh, ph, nw, pw).permute(0, 3, 5, 2, 4, 1)  # B,ph,pw,nh,nw,C
    return x.reshape(b, ph * pw, nh * nw, c)


def fold_nchw(patches: torch.Tensor, out_hw: Tuple[int, int], ph: int,
              pw: int) -> torch.Tensor:
    """Inverse of unfold_nchw: (B, P, N, C) -> (B, C, H, W)."""
    b, _, _, c = patches.shape
    h, w = out_hw
    x = patches.reshape(b, ph, pw, h // ph, w // pw, c).permute(0, 5, 3, 1, 4, 2)
    return x.reshape(b, c, h, w)


def resize_to_patch_multiple(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Bilinear resize of H and W up to the next patch multiple with
    align_corners=True (mobilevit_block.py:46-81)."""
    h, w = x.shape[-2:]
    if h % ph == 0 and w % pw == 0:
        return x
    size = (int(math.ceil(h / ph) * ph), int(math.ceil(w / pw) * pw))
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def ffn_dims(attn_unit_dim: int, ffn_multiplier: Union[Sequence, int, float],
             n_attn_blocks: int) -> List[int]:
    """Per-block FFN widths, rounded down to multiples of 16 (:102-112)."""
    m = ffn_multiplier
    if isinstance(m, Sequence) and len(m) == 2:
        dims = np.linspace(m[0], m[1], n_attn_blocks, dtype=float) * attn_unit_dim
    elif isinstance(m, Sequence) and len(m) == 1:
        dims = [m[0] * attn_unit_dim] * n_attn_blocks
    else:
        dims = [float(m) * attn_unit_dim] * n_attn_blocks
    return [int((d // 16) * 16) for d in dims]


class MobileViTBlockv2(nn.Module):
    """Local rep (dw3×3 + 1×1) → unfold → LinearAttnFFN×n + norm → fold → 1×1
    projection. Submodules are named after the flax scopes."""

    def __init__(self, opts, in_channels: int, attn_unit_dim: int,
                 ffn_multiplier: Union[Sequence, int, float] = 2.0,
                 n_attn_blocks: int = 2, attn_dropout: float = 0.0,
                 dropout: float = 0.0, ffn_dropout: float = 0.0, patch_h: int = 8,
                 patch_w: int = 8, conv_ksize: int = 3, dilation: int = 1,
                 attn_norm_layer: str = "layer_norm_2d") -> None:
        super().__init__()
        self.patch_h, self.patch_w = patch_h, patch_w
        self.n_attn_blocks = n_attn_blocks
        self.local_dw = ConvLayer2d(opts, in_channels, in_channels,
                                    kernel_size=conv_ksize, dilation=dilation,
                                    groups=in_channels)
        self.local_pw = ConvLayer2d(opts, in_channels, attn_unit_dim, kernel_size=1,
                                    use_norm=False, use_act=False)
        for i, dim in enumerate(ffn_dims(attn_unit_dim, ffn_multiplier, n_attn_blocks)):
            self.add_module(f"global_rep_{i}", LinearAttnFFN(
                opts, attn_unit_dim, dim, attn_dropout=attn_dropout, dropout=dropout,
                ffn_dropout=ffn_dropout, norm_layer=attn_norm_layer))
        self.global_norm = get_normalization_layer(opts, attn_unit_dim,
                                                   attn_norm_layer) or nn.Identity()
        self.conv_proj = ConvLayer2d(opts, attn_unit_dim, in_channels, kernel_size=1,
                                     use_act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = resize_to_patch_multiple(x, self.patch_h, self.patch_w)
        fm = self.local_pw(self.local_dw(x))
        out_hw = fm.shape[-2:]
        patches = unfold_nchw(fm, self.patch_h, self.patch_w)
        for i in range(self.n_attn_blocks):
            patches = getattr(self, f"global_rep_{i}")(patches)
        patches = self.global_norm(patches)
        return self.conv_proj(fold_nchw(patches, out_hw, self.patch_h, self.patch_w))
