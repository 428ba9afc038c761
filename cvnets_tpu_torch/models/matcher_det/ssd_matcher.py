"""SSD IoU matcher (counterpart of cvnets_tpu/models/matcher_det/ssd_matcher.py).

``__call__`` runs on the host, per sample, in the loader's worker threads
(numpy, as the JAX matcher): every anchor takes its best ground-truth box, each
box then claims its best anchor outright, anchors under the IoU threshold
become background, and the matched boxes are encoded as regression targets.
``convert_to_boxes`` decodes the model's outputs on the device (torch).
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np

from cvnets_tpu_torch.models.matcher_det import MATCHER_REGISTRY
from cvnets_tpu_torch.ops.box_utils import (
    box_iou,
    center_to_corner,
    convert_boxes_to_locations,
    convert_locations_to_boxes,
    corner_to_center,
)


def assign_priors(gt_boxes: np.ndarray, gt_labels: np.ndarray,
                  corner_form_priors: np.ndarray, iou_threshold: float,
                  background_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    if gt_labels.size == 0:
        gt_boxes = np.zeros((1, 4), np.float32)
        gt_labels = np.zeros((1,), np.int64)
    ious = box_iou(gt_boxes, corner_form_priors)  # (T, P)
    best_target_per_prior = ious.max(axis=0)
    best_target_per_prior_index = ious.argmax(axis=0)
    best_prior_per_target_index = ious.argmax(axis=1)
    best_target_per_prior_index[best_prior_per_target_index] = np.arange(len(gt_boxes))
    best_target_per_prior[best_prior_per_target_index] = 2.0
    labels = gt_labels[best_target_per_prior_index].copy()
    labels[best_target_per_prior < iou_threshold] = background_id
    return gt_boxes[best_target_per_prior_index], labels


class BaseMatcher:
    def __init__(self, opts, *args, **kwargs) -> None:
        self.opts = opts

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        return parser


@MATCHER_REGISTRY.register(name="ssd")
class SSDMatcher(BaseMatcher):
    def __init__(self, opts, bg_class_id: int = 0, *args, **kwargs) -> None:
        super().__init__(opts)
        self.center_variance = getattr(opts, "matcher.ssd.center_variance", 0.1)
        self.size_variance = getattr(opts, "matcher.ssd.size_variance", 0.2)
        self.iou_threshold = getattr(opts, "matcher.ssd.iou_threshold", 0.5)
        self.bg_class_id = bg_class_id

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--matcher.ssd.center-variance", type=float, default=0.1)
        group.add_argument("--matcher.ssd.size-variance", type=float, default=0.2)
        group.add_argument("--matcher.ssd.iou-threshold", type=float, default=0.5)
        return parser

    def __call__(self, gt_boxes_cor: np.ndarray, gt_labels: np.ndarray,
                 anchors_ctr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Corner-form normalized boxes and center-form anchors → (regression
        targets (P, 4) float32, labels (P,) int64)."""
        matched, labels = assign_priors(
            gt_boxes_cor.astype(np.float32), gt_labels.astype(np.int64),
            center_to_corner(anchors_ctr), self.iou_threshold, self.bg_class_id)
        locations = convert_boxes_to_locations(corner_to_center(matched), anchors_ctr,
                                               self.center_variance, self.size_variance)
        return locations.astype(np.float32), labels.astype(np.int64)

    def convert_to_boxes(self, pred_locations, anchors_ctr):
        """Predicted offsets → corner-form boxes (on the device)."""
        return center_to_corner(convert_locations_to_boxes(
            pred_locations, anchors_ctr, self.center_variance, self.size_variance))
