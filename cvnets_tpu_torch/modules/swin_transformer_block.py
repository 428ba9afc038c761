"""Swin transformer blocks (counterpart of cvnets_tpu/modules/swin_transformer_block.py).

Feature maps are NHWC (B, H, W, C), the JAX layout: a window partition is a
reshape and a permute, a shift is ``torch.roll``, and the relative-position
index and the shift mask are numpy arrays built from static shapes, as the JAX
module builds them at trace time. ``WindowAttention`` takes the fused kernel
(ops/window_attention.py) when ``use_kernel`` is set (from
``model.enable_pallas_kernels``, default on), the shape is eligible and no
attention dropout is active, the test of :103-106 without its TPU-only
environment switch; otherwise the einsum route of :108-121, logits in the
compute dtype and the softmax in float32. ``use_kernel = False`` is the A/B
switch. Attributes carry the flax scope names.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.layers.random_layers import StochasticDepth
from cvnets_tpu_torch.ops.window_attention import fused_window_attention, window_attention_eligible
from cvnets_tpu_torch.quantization import quant_linear


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B·nW, ws², C); H and W divisible by ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """Static (ws², ws²) index into the (2ws-1)² bias table (:36-46)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Static additive mask (nW, ws², ws²) for SW-MSA (:49-60): -100 where
    two tokens come from different regions of the rolled map, not -inf."""
    img_mask = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wslice in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wslice, :] = cnt
            cnt += 1
    mask_windows = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    mask_windows = mask_windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Fused ``qkv`` and ``proj`` over (B·nW, S, C) windows, with a learned
    relative-position bias table of ((2·ws - 1)², H)."""

    def __init__(self, opts, dim: int, num_heads: int, window_size: int,
                 attn_dropout: float = 0.0, proj_dropout: float = 0.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = quant_linear(opts, dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window_size).reshape(-1)),
                             persistent=False)
        self.proj = quant_linear(opts, dim, dim)
        self.attn_dropout = nn.Dropout(attn_dropout)
        self.proj_dropout = nn.Dropout(proj_dropout)
        # False sends every call down the einsum route (a kernel/plain A/B)
        self.use_kernel = getattr(opts, "model.enable_pallas_kernels", True) is not False

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bnw, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, h).permute(2, 0, 1).contiguous()  # (H, S, S) float32
        if (self.use_kernel and window_attention_eligible(n, c, h)
                and (self.attn_dropout.p == 0 or not self.training)):
            out = fused_window_attention(q * hd ** -0.5, k, v, h, bias, mask)
        else:
            q, k, v = (t.reshape(bnw, n, h, hd) for t in (q, k, v))
            logits = torch.einsum("bnhd,bmhd->bhnm", q * hd ** -0.5, k)
            logits = logits + bias[None].to(logits.dtype)
            if mask is not None:
                nw = mask.shape[0]
                logits = (logits.reshape(bnw // nw, nw, h, n, n)
                          + mask[None, :, None].to(logits.dtype)).reshape(bnw, h, n, n)
            attn = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
            attn = self.attn_dropout(attn)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(bnw, n, c)
        return self.proj_dropout(self.proj(out))


class SwinTransformerBlock(nn.Module):
    """W-MSA / SW-MSA + MLP over NHWC maps (:126-201). The window is never
    shrunk: a small map is padded up to whole windows (after norm1, so the pad
    is zeros) and the shift is off when the window covers the padded map."""

    def __init__(self, opts, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0, dropout: float = 0.0,
                 attn_dropout: float = 0.0, stochastic_depth_prob: float = 0.0) -> None:
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(opts, dim, num_heads, window_size,
                                    attn_dropout=attn_dropout, proj_dropout=dropout)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = quant_linear(opts, dim, int(dim * mlp_ratio))
        self.act = build_act_layer(opts)
        self.mlp_fc2 = quant_linear(opts, int(dim * mlp_ratio), dim)
        self.dropout = nn.Dropout(dropout)
        self.stochastic_depth = StochasticDepth(stochastic_depth_prob)
        self._masks: Dict[Tuple[int, int, int, torch.device], torch.Tensor] = {}

    def _shift_mask(self, hp: int, wp: int, shift: int, device: torch.device) -> torch.Tensor:
        key = (hp, wp, shift, device)
        if key not in self._masks:  # built once a map size, as at trace time in JAX
            mask = torch.from_numpy(shifted_window_mask(hp, wp, self.window_size, shift))
            if device.type == "cuda":  # from pinned memory: the copy does not block
                mask = mask.pin_memory()
            self._masks[key] = mask.to(device, non_blocking=True)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window_size
        pad_h, pad_w = (-h) % ws, (-w) % ws
        hp, wp = h + pad_h, w + pad_w
        shift = self.shift_size if ws < min(hp, wp) else 0

        y = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self._shift_mask(hp, wp, shift, x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.stochastic_depth(y[:, :h, :w, :])

        y = self.dropout(self.act(self.mlp_fc1(self.norm2(x))))
        y = self.dropout(self.mlp_fc2(y))
        return x + self.stochastic_depth(y)


class PatchMerging(nn.Module):
    """2×2 merge (:204-229): concat [x(0,0), x(1,0), x(0,1), x(1,1)] (torchvision's
    order, which the checkpoints' channels follow), LayerNorm, Linear 4C → 2C
    without bias. An odd map is padded by one row or column first."""

    def __init__(self, opts, dim: int) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = LinearLayer(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))
