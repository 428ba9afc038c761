"""Paste fixed-resolution instance masks into full-image masks (counterpart of
cvnets_tpu/ops/mask_paste.py), with static shapes.

The JAX formulation inverts torchvision's ``paste_masks_in_image``: every
output pixel samples the M×M mask bilinearly at its box-normalized
coordinate, by the half-pixel mapping of ``F.interpolate(align_corners=False)``
(source index clipped to the mask), and is 0 outside the box. Bilinear
sampling is separable, so each mask's paste is ``Wy · mask · Wxᵀ`` with
per-box interpolation matrices: two batched matrix products, no gather.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _axis_weights(coords: torch.Tensor, m: int) -> torch.Tensor:
    """(..., P, m): weight ``1 - frac`` at ``clip(floor(c))`` and ``frac`` at
    ``clip(floor(c) + 1)``."""
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.long()
    idx = torch.arange(m, device=coords.device)
    return ((idx == lo.clamp(0, m - 1)[..., None]) * (1 - frac)[..., None]
            + (idx == (lo + 1).clamp(0, m - 1)[..., None]) * frac[..., None])


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor,
                img_hw: Tuple[int, int]) -> torch.Tensor:
    """``masks`` (..., N, M, M) probabilities in box-local coordinates,
    ``boxes`` (..., N, 4) corner-form image pixels → (..., N, H, W) float32,
    0 outside each box."""
    h, w = int(img_hw[0]), int(img_hw[1])
    m = masks.shape[-1]
    masks, boxes = masks.float(), boxes.float()
    ys = torch.arange(h, dtype=torch.float32, device=masks.device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=masks.device) + 0.5
    x1, y1, x2, y2 = (t[..., None] for t in boxes.unbind(-1))
    bw = (x2 - x1).clamp(min=1e-3)
    bh = (y2 - y1).clamp(min=1e-3)
    wx = _axis_weights((xs - x1) / bw * m - 0.5, m)  # (..., N, W, M)
    wy = _axis_weights((ys - y1) / bh * m - 0.5, m)  # (..., N, H, M)
    out = torch.matmul(torch.matmul(wy, masks), wx.transpose(-1, -2))
    inside_y = (ys >= y1) & (ys <= y2)
    inside_x = (xs >= x1) & (xs <= x2)
    return out * (inside_y[..., :, None] & inside_x[..., None, :])
