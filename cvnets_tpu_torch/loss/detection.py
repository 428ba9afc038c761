"""Detection losses (counterpart of cvnets_tpu/loss/detection.py).

``SSDLoss``: smooth-L1 of the box offsets on the positive anchors, plus cross
entropy on the positives and on the hardest negatives, ``neg_pos_ratio``
times as many as an image's positives, over the number of positives. The
negatives are ranked as the JAX loss ranks them, by a stable descending sort
of the background loss (positives last), so tied losses pick the same
anchors; the rank is the sort's inverse permutation, made by a scatter.
``MaskRCNNLoss`` keeps its registry name and raises: it waits for ROADMAP.md
queue 1 item 10.
"""

from __future__ import annotations

import argparse
from typing import Any

import torch

from cvnets_tpu_torch.loss import LOSS_REGISTRY
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria


@LOSS_REGISTRY.register(name="__base__", type="detection")
class BaseDetectionCriteria(BaseCriteria):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseDetectionCriteria:
            return parser
        group = parser.add_argument_group(title="Detection loss arguments")
        group.add_argument("--loss.detection.name", type=str, default="ssd_multibox_loss")
        return parser


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


@LOSS_REGISTRY.register(name="ssd_multibox_loss", type="detection")
class SSDLoss(BaseDetectionCriteria):
    def __init__(self, opts, *args, **kwargs) -> None:
        super().__init__(opts)
        self.neg_pos_ratio = getattr(opts, "loss.detection.ssd_multibox_loss.neg_pos_ratio", 3)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--loss.detection.ssd-multibox-loss.neg-pos-ratio", type=int,
                           default=3)
        group.add_argument("--loss.detection.ssd-multibox-loss.label-smoothing", type=float,
                           default=0.0, help="Parsed and not read, as in the JAX loss")
        return parser

    def __call__(self, input_sample: Any, prediction: Any, target: Any,
                 **kwargs) -> torch.Tensor:
        scores = prediction["scores"].float()  # (B, P, C)
        pred_locations = prediction["boxes"].float()  # (B, P, 4)
        gt_labels = target["box_labels"]  # (B, P)
        gt_locations = target["box_coordinates"]  # (B, P, 4)

        log_probs = torch.log_softmax(scores, dim=-1)
        pos_mask = gt_labels > 0
        num_pos = pos_mask.sum(dim=1, keepdim=True)  # (B, 1)
        with torch.no_grad():
            neg_loss = torch.where(pos_mask, float("-inf"), -log_probs[..., 0])
            order = torch.sort(-neg_loss, dim=1, stable=True).indices
            ranks = torch.empty_like(order).scatter_(
                1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
            neg_mask = ~pos_mask & (ranks < self.neg_pos_ratio * num_pos)
        mask = pos_mask | neg_mask
        ce = -log_probs.gather(-1, gt_labels.clamp(min=0)[..., None])[..., 0]
        cls_loss = (ce * mask).sum()
        reg = smooth_l1(pred_locations, gt_locations.float()).sum(dim=-1)
        reg_loss = (reg * pos_mask).sum()
        return (cls_loss + reg_loss) / num_pos.sum().clamp(min=1)


@LOSS_REGISTRY.register(name="mask_rcnn_loss", type="detection")
class MaskRCNNLoss(BaseDetectionCriteria):
    def __init__(self, opts, *args, **kwargs) -> None:
        raise NotImplementedError(
            "not ported yet: the Mask R-CNN loss waits for ROADMAP.md queue 1 item 10")
