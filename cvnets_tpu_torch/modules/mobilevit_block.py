"""MobileViT blocks (counterpart of cvnets_tpu/modules/mobilevit_block.py):
``MobileViTBlockv2`` (:84-158) and v1's ``MobileViTBlock`` (:161-251).

The convs run NCHW; the attention runs on (B, P, N, C) patches, the JAX package's
layout. ``unfold_nchw``/``fold_nchw`` produce and consume exactly the patches of the
JAX ``unfold_nhwc``/``fold_nhwc`` (:27-43), as one reshape and permute each. v1
attends along N (across patches, at one pixel offset p), with (B·P, N, C) as the
transformer's batch: a reshape of the same patches.

Both blocks have the temporal forward of the video models (v2 :114-158, v1
:182-235): with ``x_prev``, the previous frame's post-norm patches (v2:
(B, P, M, C); v1: (B·P, M, C)), every attention layer of the block takes
its keys (v1) or its q and k (v2) from them; ``return_patches`` also
returns this frame's post-norm patches, for the next frame.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.normalization import get_normalization_layer
from cvnets_tpu_torch.modules.transformer import LinearAttnFFN, TransformerEncoder
from cvnets_tpu_torch.ops.seg_ce import resize_bilinear


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

    def forward(self, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None,
                return_patches: bool = False):
        x = resize_to_patch_multiple(x, self.patch_h, self.patch_w)
        fm = self.local_pw(self.local_dw(x))
        out_hw = fm.shape[-2:]
        patches = unfold_nchw(fm, self.patch_h, self.patch_w)
        for i in range(self.n_attn_blocks):
            patches = getattr(self, f"global_rep_{i}")(patches, x_prev)
        patches = self.global_norm(patches)
        fm = self.conv_proj(fold_nchw(patches, out_hw, self.patch_h, self.patch_w))
        return (fm, patches) if return_patches else fm


class MobileViTBlock(nn.Module):
    """v1: local rep (k×k conv + 1×1) → unfold → ``TransformerEncoder``×n
    along N → ``global_norm`` → fold → 1×1 ``conv_proj`` → k×k ``fusion`` over
    concat(input, global). A map whose H or W is not a multiple of the patch
    goes up to the next multiple and back down after the fold, both by
    ``jax.image.resize``'s bilinear weights (``resize_bilinear``: the way down
    antialiases, as the JAX block's does)."""

    def __init__(self, opts, in_channels: int, transformer_dim: int, ffn_dim: int,
                 n_transformer_blocks: int = 2, head_dim: int = 32,
                 attn_dropout: float = 0.0, dropout: float = 0.0, ffn_dropout: float = 0.0,
                 patch_h: int = 8, patch_w: int = 8, conv_ksize: int = 3,
                 dilation: int = 1, no_fusion: bool = False,
                 transformer_norm_layer: str = "layer_norm") -> None:
        super().__init__()
        self.patch_h, self.patch_w = patch_h, patch_w
        self.n_transformer_blocks = n_transformer_blocks
        self.local_conv = ConvLayer2d(opts, in_channels, in_channels, kernel_size=conv_ksize,
                                      dilation=dilation)
        self.local_pw = ConvLayer2d(opts, in_channels, transformer_dim, kernel_size=1,
                                    use_norm=False, use_act=False)
        num_heads = max(1, transformer_dim // head_dim)
        for i in range(n_transformer_blocks):
            self.add_module(f"global_rep_{i}", TransformerEncoder(
                opts, transformer_dim, ffn_dim, num_heads=num_heads,
                attn_dropout=attn_dropout, dropout=dropout, ffn_dropout=ffn_dropout,
                transformer_norm_layer=transformer_norm_layer))
        self.global_norm = get_normalization_layer(
            opts, transformer_dim, transformer_norm_layer) or nn.Identity()
        self.conv_proj = ConvLayer2d(opts, transformer_dim, in_channels, kernel_size=1)
        self.fusion = None if no_fusion else ConvLayer2d(
            opts, 2 * in_channels, in_channels, kernel_size=conv_ksize)

    def forward(self, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None,
                return_patches: bool = False):
        fm = self.local_pw(self.local_conv(x))
        orig_hw = tuple(fm.shape[-2:])
        ph, pw = self.patch_h, self.patch_w
        padded_hw = (math.ceil(orig_hw[0] / ph) * ph, math.ceil(orig_hw[1] / pw) * pw)
        if padded_hw != orig_hw:
            fm = resize_bilinear(fm, padded_hw)
        patches = unfold_nchw(fm, ph, pw)
        b, p, n, c = patches.shape
        tokens = patches.reshape(b * p, n, c)
        for i in range(self.n_transformer_blocks):
            tokens = getattr(self, f"global_rep_{i}")(tokens, x_prev)
        tokens = self.global_norm(tokens)
        fm = fold_nchw(tokens.reshape(b, p, n, c), padded_hw, ph, pw)
        if padded_hw != orig_hw:
            fm = resize_bilinear(fm, orig_hw)
        fm = self.conv_proj(fm)
        if self.fusion is not None:
            fm = self.fusion(torch.cat([x, fm], dim=1))
        return (fm, tokens) if return_patches else fm
