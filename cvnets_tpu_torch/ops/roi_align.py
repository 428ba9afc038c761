"""RoIAlign in plain torch (counterpart of cvnets_tpu/ops/roi_align.py; the card
machine has no torchvision).

Bilinear sampling at ``sampling_ratio²`` points an output bin, averaged: the
``aligned=True`` convention (half-pixel offset). The JAX formulation is kept:
bilinear interpolation is separable and linear, so the op is two products
against per-roi interpolation matrices, ``out = Wx · (Wy · F)``, with the
mean over the sample points folded into the matrices. The forward gathers
nothing and the backward scatters nothing (``dF = Wyᵀ · (Wxᵀ · dout)`` is
again a product), so both passes are batched matrix products.

``multiscale_roi_align`` assigns each roi its FPN level by eq. 1 of the FPN
paper and, as in JAX, aligns every roi on every level, then selects with a
one-hot product (L times the work of one level, no data-dependent shapes).

Layout: feature maps (B, C, H, W), boxes (B, N, 4) corner-form, out
(B, N, C, out_h, out_w); the JAX functions take one image, NHWC, under
``vmap``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _interp_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """W[..., p, k]: the weight of source element ``k`` for the sample at
    ``coords[..., p]``; ``1 - frac`` at ``clip(floor(c))`` and ``frac`` at
    ``clip(floor(c) + 1)``, both clipped to [0, size - 1]."""
    c0 = torch.floor(coords)
    frac = coords - c0
    c0 = c0.long()
    lo = c0.clamp(0, size - 1)[..., None]
    hi = (c0 + 1).clamp(0, size - 1)[..., None]
    idx = torch.arange(size, device=coords.device)
    return (idx == lo) * (1.0 - frac)[..., None] + (idx == hi) * frac[..., None]


def _sample_coords(start: torch.Tensor, bin_size: torch.Tensor, n_out: int, s: int,
                   offset: float) -> torch.Tensor:
    """(..., n_out, s): the sample positions of each output bin."""
    grid = (torch.arange(n_out, device=start.device, dtype=start.dtype)[:, None]
            + (torch.arange(s, device=start.device, dtype=start.dtype)[None, :] + 0.5) / s)
    return start[..., None, None] + grid * bin_size[..., None, None] - offset


def roi_align_matrices(boxes: torch.Tensor, height: int, width: int,
                       output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 2,
                       aligned: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Wy (..., out_h, H), Wx (..., out_w, W)) of ``boxes`` (..., 4) in the
    map's pixels, the sample mean folded in."""
    oh, ow = output_size
    offset = 0.5 if aligned else 0.0
    boxes = boxes.to(torch.promote_types(boxes.dtype, torch.float32))
    x1, y1, x2, y2 = boxes.unbind(-1)
    bin_w = (x2 - x1).clamp(min=1e-4) / ow
    bin_h = (y2 - y1).clamp(min=1e-4) / oh
    ys = _sample_coords(y1, bin_h, oh, sampling_ratio, offset)
    xs = _sample_coords(x1, bin_w, ow, sampling_ratio, offset)
    return _interp_matrix(ys, height).mean(dim=-2), _interp_matrix(xs, width).mean(dim=-2)


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """``features`` (B, C, H, W), ``boxes`` (B, N, 4) in the map's pixels →
    (B, N, C, out_h, out_w)."""
    b, c, h, w = features.shape
    n = boxes.shape[1]
    oh, ow = output_size
    wy, wx = roi_align_matrices(boxes, h, w, output_size, sampling_ratio, aligned)
    wy, wx = wy.to(features.dtype), wx.to(features.dtype)
    # rows[b, n·i, c·x] = Σ_y Wy[b, n, i, y] F[b, c, y, x]
    rows = torch.matmul(wy.reshape(b, n * oh, h), features.transpose(1, 2).reshape(b, h, c * w))
    # out[b·n, i·c, j] = Σ_x rows[b·n, i·c, x] Wx[b, n, j, x]
    out = torch.matmul(rows.reshape(b * n, oh * c, w), wx.reshape(b * n, ow, w).transpose(1, 2))
    return out.reshape(b, n, oh, c, ow).permute(0, 1, 3, 2, 4)


def fpn_levels(boxes: torch.Tensor, n_levels: int, canonical_scale: int = 224,
               canonical_level: int = 4) -> torch.Tensor:
    """Each box's level, 0 … n_levels - 1, by eq. 1 of the FPN paper."""
    boxes = boxes.to(torch.promote_types(boxes.dtype, torch.float32))
    areas = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
             * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
    k = torch.floor(canonical_level + torch.log2(torch.sqrt(areas) / canonical_scale + 1e-8))
    k_min = canonical_level - (n_levels - 1)
    return (k.clamp(k_min, canonical_level) - k_min).long()


def multiscale_roi_align(feature_maps: Sequence[torch.Tensor], boxes: torch.Tensor,
                         strides: Sequence[float], output_size: Tuple[int, int] = (7, 7),
                         sampling_ratio: int = 2, canonical_scale: int = 224,
                         canonical_level: int = 4) -> torch.Tensor:
    """Per-level maps (B, C, H_l, W_l) at ``strides``, ``boxes`` (B, N, 4) in
    image pixels → (B, N, C, out_h, out_w): every roi aligned on every level,
    then its own level selected."""
    levels = fpn_levels(boxes, len(feature_maps), canonical_scale, canonical_level)
    outs = [roi_align(fm, boxes / stride, output_size, sampling_ratio)
            for fm, stride in zip(feature_maps, strides)]
    stacked = torch.stack(outs, dim=0)  # (L, B, N, C, oh, ow)
    sel = torch.nn.functional.one_hot(levels, len(feature_maps)).to(stacked.dtype)
    return torch.einsum("lbnchw,bnl->bnchw", stacked, sel)
