"""Mask R-CNN building blocks (counterpart of
cvnets_tpu/models/detection/utils/rcnn_utils.py): the RPN head, the box
head's convs and fc, the box predictor, the mask head, the R-CNN box coder,
the matcher with low-quality forcing and the balanced sampler, with static
shapes (a sample is a 0/1 mask, not a list of indices).

Heads are NCHW. The box head flattens its 7×7 map in the flax (h, w, c)
order, so a flax ``fc`` kernel loads as it is. Without
``--model.detection.mask-rcnn.norm-layer`` the head convs have a bias and no
norm, as in JAX.

The sampler takes its uniform draws as tensors (``rand_pos``, ``rand_neg``),
so that a caller can give it any generator's draws, or JAX's. JAX ranks with
``jnp.argsort`` and keeps the lower index among ties; so does every rank
here (a stable sort).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import BlockConvTranspose, ConvLayer2d
from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.ops.box_utils import box_iou


def _head_conv(opts, in_ch: int, out_ch: int, kernel_size: int = 3) -> ConvLayer2d:
    norm = getattr(opts, "model.detection.mask_rcnn.norm_layer", None)
    return ConvLayer2d(opts, in_ch, out_ch, kernel_size, use_norm=norm is not None,
                       norm_name=norm, use_act=True, bias=norm is None)


class RPNHead(nn.Module):
    """3×3 conv (``conv_0``), then 1×1 objectness (``cls_logits``) and box
    deltas (``bbox_pred``), shared over the levels; the predictors drawn from
    normal(0.01), as JAX's."""

    def __init__(self, opts, in_channels: int, num_anchors: int, conv_depth: int = 1) -> None:
        super().__init__()
        self.conv_depth = conv_depth
        for i in range(conv_depth):
            self.add_module(f"conv_{i}", _head_conv(opts, in_channels, in_channels))
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)
        self.cls_logits.weight_init = self.bbox_pred.weight_init = ("normal", 0.01)

    def forward(self, features: List[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, deltas = [], []
        for t in features:
            for i in range(self.conv_depth):
                t = getattr(self, f"conv_{i}")(t)
            logits.append(self.cls_logits(t))
            deltas.append(self.bbox_pred(t))
        return logits, deltas


class FastRCNNConvFCHead(nn.Module):
    """4 × 3×3 conv, flatten in (h, w, c) order, fc, ReLU."""

    def __init__(self, opts, conv_channels: int = 256, fc_dim: int = 1024, n_convs: int = 4,
                 roi_size: int = 7) -> None:
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"conv_{i}", _head_conv(opts, conv_channels, conv_channels))
        self.fc = LinearLayer(roi_size * roi_size * conv_channels, fc_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = getattr(self, f"conv_{i}")(x)
        return torch.relu(self.fc(x.permute(0, 2, 3, 1).flatten(1)))


class FastRCNNPredictor(nn.Module):
    """Class scores (normal(0.01)) and per-class box deltas (normal(0.001))."""

    def __init__(self, in_features: int, n_classes: int) -> None:
        super().__init__()
        self.cls_score = LinearLayer(in_features, n_classes)
        self.bbox_pred = LinearLayer(in_features, n_classes * 4)
        self.cls_score.weight_init = ("normal", 0.01)
        self.bbox_pred.weight_init = ("normal", 0.001)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


class MaskRCNNHeads(nn.Module):
    """4 × 3×3 conv (``mask_fcn1..4``), a 2×2 stride-2 transposed conv
    (``deconv``), ReLU, 1×1 per-class logits (``mask_logits``)."""

    def __init__(self, opts, channels: int = 256, n_convs: int = 4, n_classes: int = 81) -> None:
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"mask_fcn{i + 1}", _head_conv(opts, channels, channels))
        self.deconv = BlockConvTranspose(channels, channels, 2)
        self.deconv.weight_init = "lecun_normal"  # flax's default: JAX passes no kernel_init
        self.mask_logits = ConvLayer2d(opts, channels, n_classes, 1, bias=True,
                                       use_norm=False, use_act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = getattr(self, f"mask_fcn{i + 1}")(x)
        return self.mask_logits(torch.relu(self.deconv(x)))


# ------------------------------------------------- box coding (R-CNN weights)

BBOX_XFORM_CLIP = float(math.log(1000.0 / 16))


def encode_boxes(ref_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Corner-form boxes → (dx, dy, dw, dh) against ``ref_boxes`` (torchvision
    ``BoxCoder``)."""
    wx, wy, ww, wh = weights
    ex_w = ref_boxes[..., 2] - ref_boxes[..., 0]
    ex_h = ref_boxes[..., 3] - ref_boxes[..., 1]
    ex_cx = ref_boxes[..., 0] + 0.5 * ex_w
    ex_cy = ref_boxes[..., 1] + 0.5 * ex_h
    gt_w = (gt_boxes[..., 2] - gt_boxes[..., 0]).clamp(min=1e-4)
    gt_h = (gt_boxes[..., 3] - gt_boxes[..., 1]).clamp(min=1e-4)
    gt_cx = gt_boxes[..., 0] + 0.5 * gt_w
    gt_cy = gt_boxes[..., 1] + 0.5 * gt_h
    ex_w, ex_h = ex_w.clamp(min=1e-4), ex_h.clamp(min=1e-4)
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w, wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w), wh * torch.log(gt_h / ex_h)], dim=-1)


def decode_boxes(deltas: torch.Tensor, ref_boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    wx, wy, ww, wh = weights
    w = ref_boxes[..., 2] - ref_boxes[..., 0]
    h = ref_boxes[..., 3] - ref_boxes[..., 1]
    cx = ref_boxes[..., 0] + 0.5 * w
    cy = ref_boxes[..., 1] + 0.5 * h
    dx, dy, dw, dh = deltas.unbind(-1)
    dw = (dw / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (dh / wh).clamp(max=BBOX_XFORM_CLIP)
    pcx = cx + dx / wx * w
    pcy = cy + dy / wy * h
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph],
                       dim=-1)


# ----------------------------------------- matching + balanced sampling (static)


def match_boxes(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                high: float, low: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``anchors`` (..., A, 4), ``gt_boxes`` (..., G, 4), ``gt_valid`` (..., G)
    → (matched gt index (..., A), label (..., A): 1 positive, 0 negative, -1
    ignored). Each valid gt's best anchors are forced positive (torchvision's
    ``Matcher`` with ``allow_low_quality_matches``)."""
    ious = box_iou(anchors, gt_boxes)
    ious = torch.where(gt_valid[..., None, :], ious, -1.0)
    best_iou, best_idx = ious.max(dim=-1)  # the first of equal maxima, as jnp.argmax
    labels = torch.where(best_iou >= high, 1, torch.where(best_iou < low, 0, -1))
    gt_best = ious.amax(dim=-2, keepdim=True)
    force = ((ious >= gt_best - 1e-5) & gt_valid[..., None, :] & (gt_best > 0)).any(dim=-1)
    return best_idx, torch.where(force, 1, labels)


def stable_rank(values: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Each entry's place along the last axis in a stable sort (ties keep the
    lower index first): ``jnp.argsort(jnp.argsort(values))``."""
    order = torch.sort(values, dim=-1, descending=descending, stable=True).indices
    ranks = torch.empty_like(order)
    return ranks.scatter_(-1, order, torch.arange(order.shape[-1], device=order.device)
                          .expand_as(order))


def balanced_sample_mask(labels: torch.Tensor, num_samples: int, pos_fraction: float,
                         rand_pos: torch.Tensor, rand_neg: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_mask, neg_mask) over the last axis of ``labels``: at most
    ``num_samples · pos_fraction`` positives and the rest negatives, each
    the lowest of its uniform draws (``rand_pos``, ``rand_neg``)."""
    n_pos_target = int(num_samples * pos_fraction)
    pos, neg = labels == 1, labels == 0
    p_rank = stable_rank(torch.where(pos, rand_pos, 2.0))
    n_pos = pos.sum(dim=-1, keepdim=True).clamp(max=n_pos_target)
    pos_mask = pos & (p_rank < n_pos)
    n_rank = stable_rank(torch.where(neg, rand_neg, 2.0))
    n_neg = torch.minimum(neg.sum(dim=-1, keepdim=True), num_samples - n_pos)
    return pos_mask, neg & (n_rank < n_neg)


def top_k_stable(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest, ties to the lower
    index (``torch.topk`` promises no order among ties)."""
    top = torch.sort(values, dim=-1, descending=True, stable=True)
    return top.values[..., :k], top.indices[..., :k]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, n]]`` for x (B, N, ...) and idx (B, K)."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                    .expand(idx.shape + x.shape[2:]))
