"""Segmentation losses (counterpart of cvnets_tpu/loss/segmentation.py).

``SegCrossEntropy``: float32 pixel CE with an ignore index, label smoothing,
optional inverse-log-frequency class weights and an aux-head weight. The
weighted sum is divided by the *unweighted* number of valid pixels, as in the
JAX package (``F.cross_entropy(weight=...)`` would divide by the sum of
weights). Head-resolution NCHW logits, smaller than the labels, go through the
fused resize + CE (``ops/seg_ce.py``) where its kernels take the shape
(``seg_ce_eligible``), else through the unfused plain version, as the JAX
package falls back to its scan path; logits already at the labels' size take
the plain CE (segmentation.py:76-91). ``use_kernel = False`` sends every resize
through the unfused plain version (the kernel/plain A/B).

In training in a process group both the valid-pixel count and the class
weights' histogram are those of the global batch: each rank divides its
pixel sum by ``parallel.mean_divisor`` of its count (the all-reduced count
over the world size), and the class weights come from the all-reduced
histogram, so the step is JAX's on the global batch. Evaluation divides by
the rank's own count.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Union

import torch

from cvnets_tpu_torch.loss import LOSS_REGISTRY
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria
from cvnets_tpu_torch.ops.seg_ce import fused_resize_ce_sum, resize_ce_plain_sum
from cvnets_tpu_torch.ops.seg_ce_kernel import pixel_ce, seg_ce_eligible
from cvnets_tpu_torch.parallel import mean_divisor


@LOSS_REGISTRY.register(name="__base__", type="segmentation")
class BaseSegmentationCriteria(BaseCriteria):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseSegmentationCriteria:
            return parser
        group = parser.add_argument_group(title="Segmentation loss arguments")
        group.add_argument("--loss.segmentation.name", type=str, default="cross_entropy")
        return parser


@LOSS_REGISTRY.register(name="cross_entropy", type="segmentation")
class SegCrossEntropy(BaseSegmentationCriteria):
    def __init__(self, opts) -> None:
        super().__init__(opts)
        self.ignore_idx = getattr(opts, "loss.segmentation.cross_entropy.ignore_index", 255)
        self.label_smoothing = getattr(
            opts, "loss.segmentation.cross_entropy.label_smoothing", 0.0) or 0.0
        self.aux_wt = getattr(opts, "loss.segmentation.cross_entropy.aux_weight", 0.4)
        self.use_class_wts = getattr(opts, "loss.segmentation.cross_entropy.class_weights",
                                     False)
        self.use_kernel = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--loss.segmentation.cross-entropy.class-weights",
                           action="store_true")
        group.add_argument("--loss.segmentation.cross-entropy.aux-weight",
                           type=float, default=0.4)
        group.add_argument("--loss.segmentation.cross-entropy.ignore-index",
                           type=int, default=255)
        group.add_argument("--loss.segmentation.cross-entropy.label-smoothing",
                           type=float, default=0.0)
        return parser

    def _ce(self, logits: torch.Tensor, target: torch.Tensor,
            global_batch: bool = False) -> torch.Tensor:
        """logits (B, C, h, w), target (B, H, W); ``global_batch``: divide by
        the global batch's count (training in a process group)."""
        _, n_classes, h, w = logits.shape
        safe = torch.where(target == self.ignore_idx, 0, target)
        wts = (self._class_weights(safe, n_classes, global_batch=global_batch)
               if self.use_class_wts else None)
        if tuple(logits.shape[2:]) != tuple(target.shape[1:]):
            fused = self.use_kernel and seg_ce_eligible(h, w, *target.shape[1:], n_classes)
            fn = fused_resize_ce_sum if fused else resize_ce_plain_sum
            loss_sum, n_valid = fn(logits.permute(0, 2, 3, 1), target,
                                   ignore_idx=self.ignore_idx,
                                   label_smoothing=self.label_smoothing, class_wts=wts)
        else:
            loss, valid = pixel_ce(logits.permute(0, 2, 3, 1), target, wts, self.ignore_idx,
                                   self.label_smoothing)
            loss_sum, n_valid = loss.sum(), valid.sum(dtype=torch.float32)
        return loss_sum / mean_divisor(n_valid, global_batch)

    def __call__(self, input_sample: Any, prediction: Any, target: torch.Tensor,
                 training: bool = False, **kwargs
                 ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        if isinstance(prediction, dict) and "segmentation_output" in prediction:
            main = self._ce(prediction["segmentation_output"], target, training)
            if "aux_output" in prediction:
                aux = self._ce(prediction["aux_output"], target, training)
                return {"total_loss": main + self.aux_wt * aux, "seg_loss": main,
                        "aux_loss": aux}
            return main
        return self._ce(prediction, target, training)
