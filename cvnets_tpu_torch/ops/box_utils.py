"""Box coordinates (counterpart of cvnets_tpu/ops/box_utils.py): corner form
[x1, y1, x2, y2] ↔ center form [cx, cy, w, h], SSD's offset encoding and
decoding with center and size variances, and pairwise IoU. Each function takes
numpy arrays (the host-side matching of the data path) or torch tensors (the
decode on the device) and returns the same kind, in the JAX functions'
arithmetic."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

Arr = Union[np.ndarray, torch.Tensor]


def _cat(parts, like: Arr) -> Arr:
    if isinstance(like, torch.Tensor):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def _maximum(a: Arr, b) -> Arr:
    if isinstance(a, torch.Tensor):
        return torch.maximum(a, b if isinstance(b, torch.Tensor) else torch.as_tensor(
            b, dtype=a.dtype, device=a.device))
    return np.maximum(a, b)


def _minimum(a: Arr, b: Arr) -> Arr:
    return torch.minimum(a, b) if isinstance(a, torch.Tensor) else np.minimum(a, b)


def _clip0(a: Arr) -> Arr:
    return a.clamp(min=0) if isinstance(a, torch.Tensor) else a.clip(0)


def corner_to_center(boxes: Arr) -> Arr:
    xy = (boxes[..., :2] + boxes[..., 2:]) * 0.5
    wh = boxes[..., 2:] - boxes[..., :2]
    return _cat([xy, wh], boxes)


def center_to_corner(boxes: Arr) -> Arr:
    tl = boxes[..., :2] - boxes[..., 2:] * 0.5
    br = boxes[..., :2] + boxes[..., 2:] * 0.5
    return _cat([tl, br], boxes)


def convert_boxes_to_locations(gt_center: Arr, prior_center: Arr,
                               center_variance: float = 0.1,
                               size_variance: float = 0.2) -> Arr:
    """Center-form ground-truth boxes as SSD regression targets against priors."""
    eps = 1e-8
    log = torch.log if isinstance(gt_center, torch.Tensor) else np.log
    d_xy = (gt_center[..., :2] - prior_center[..., :2]) / (
        prior_center[..., 2:] + eps) / center_variance
    d_wh = log(_maximum(gt_center[..., 2:], eps)
               / _maximum(prior_center[..., 2:], eps)) / size_variance
    return _cat([d_xy, d_wh], gt_center)


def convert_locations_to_boxes(locations: Arr, prior_center: Arr,
                               center_variance: float = 0.1,
                               size_variance: float = 0.2) -> Arr:
    """SSD regression outputs back to center-form boxes."""
    exp = torch.exp if isinstance(locations, torch.Tensor) else np.exp
    xy = locations[..., :2] * center_variance * prior_center[..., 2:] + prior_center[..., :2]
    wh = exp(locations[..., 2:] * size_variance) * prior_center[..., 2:]
    return _cat([xy, wh], locations)


def box_area(boxes: Arr) -> Arr:
    return _clip0(boxes[..., 2] - boxes[..., 0]) * _clip0(boxes[..., 3] - boxes[..., 1])


def box_iou(boxes_a: Arr, boxes_b: Arr, eps: float = 1e-7) -> Arr:
    """Pairwise IoU of corner-form boxes: (..., N, 4) × (..., M, 4) → (..., N, M)."""
    tl = _maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    br = _minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = _clip0(br - tl)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes_a)[..., :, None] + box_area(boxes_b)[..., None, :] - inter
    return inter / (union + eps)
