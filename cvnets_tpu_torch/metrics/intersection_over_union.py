"""mIoU (counterpart of cvnets_tpu/metrics/intersection_over_union.py:16).

Each step counts, on the device, the confusion matrix of its valid pixels in
one histogram of ``C · target + pred`` (a scatter-add into C² + 1 bins, the
last one taking the ignored pixels: ``torch.bincount`` on a CUDA tensor reads
its largest value back to size its output, a host sync each step). The JAX
metric builds two one-hot tensors of (B, H, W, C) instead: 315M elements each at
8 × 512² × 150. Per-class intersection and union leave the step as int64
vector sums, which stay exact on the device and through ``pairs_to_host``'s
float64 read-back up to 2^53 pixels. The mIoU is the mean over the classes
with a non-empty union, × 100.

A label outside [0, C) that is not the ignore index is not counted (the JAX
one-hot clamps it to class C - 1).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.metrics import METRICS_REGISTRY
from cvnets_tpu_torch.metrics.metric_base import AverageMetric


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, n_classes: int,
                     ignore_idx: int) -> torch.Tensor:
    """(C, C) int64 counts, rows the target class and columns the predicted one,
    of the pixels whose target is a class; on ``pred``'s device, no host sync."""
    target = target.long()
    valid = (target != ignore_idx) & (target >= 0) & (target < n_classes)
    bins = torch.where(valid, target * n_classes + pred.long(), n_classes * n_classes)
    counts = torch.zeros(n_classes * n_classes + 1, dtype=torch.int64, device=pred.device)
    counts.scatter_add_(0, bins.flatten(), torch.ones_like(bins.flatten()))
    return counts[:-1].view(n_classes, n_classes)


def intersection_union(conf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    inter = conf.diagonal()
    return inter, conf.sum(0) + conf.sum(1) - inter


def mean_iou(inter: np.ndarray, union: np.ndarray) -> float:
    present = union > 0
    if not present.any():
        return 0.0
    return float(np.mean(inter[present] / union[present]) * 100.0)


@METRICS_REGISTRY.register(name="iou")
class IoUMetric(AverageMetric):
    def __init__(self, opts=None, **kwargs) -> None:
        self.n_classes = getattr(opts, "model.segmentation.n_classes", 21) if opts else 21
        self.ignore_idx = getattr(opts, "loss.segmentation.cross_entropy.ignore_index",
                                  255) if opts else 255
        super().__init__(opts, **kwargs)

    def reset(self) -> None:
        super().reset()
        self._inter = np.zeros(self.n_classes, np.float64)
        self._union = np.zeros(self.n_classes, np.float64)

    def batch_values(self, prediction, target, extras=None
                     ) -> Dict[str, Tuple[torch.Tensor, float]]:
        prediction, target = self._select(prediction, target)
        if isinstance(prediction, dict):
            prediction = prediction.get("segmentation_output",
                                        next(iter(prediction.values())))
        inter, union = intersection_union(confusion_matrix(
            prediction.argmax(dim=1), target, self.n_classes, self.ignore_idx))
        return {"intersection": (inter, 1.0), "union": (union, 1.0)}

    def update_values(self, values: Dict[str, Tuple]) -> None:
        self._inter += np.asarray(values["intersection"][0], np.float64)
        self._union += np.asarray(values["union"][0], np.float64)

    def compute(self) -> float:
        return mean_iou(self._inter, self._union)
