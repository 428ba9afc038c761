"""Segmentation losses (counterpart of cvnets_tpu/loss/segmentation.py).

``SegCrossEntropy``: float32 pixel CE with an ignore index, label smoothing,
optional inverse-log-frequency class weights and an aux-head weight. The
weighted sum is divided by the *unweighted* number of valid pixels, as in the
JAX package (``F.cross_entropy(weight=...)`` would divide by the sum of
weights). Head-resolution NCHW logits, smaller than the labels, go through the
fused resize + CE (``ops/seg_ce.py``); logits already at the labels' size take
the plain CE (segmentation.py:76-91). ``use_kernel = False`` sends the fused
case through the unfused plain version instead (the kernel/plain A/B).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Union

import torch

from cvnets_tpu_torch.loss import LOSS_REGISTRY
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria
from cvnets_tpu_torch.ops.seg_ce import fused_resize_ce, resize_ce_plain
from cvnets_tpu_torch.ops.seg_ce_kernel import pixel_ce


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

    def _ce(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """logits (B, C, h, w), target (B, H, W)."""
        n_classes = logits.shape[1]
        safe = torch.where(target == self.ignore_idx, 0, target)
        wts = self._class_weights(safe, n_classes) if self.use_class_wts else None
        if tuple(logits.shape[2:]) != tuple(target.shape[1:]):
            fn = fused_resize_ce if self.use_kernel else resize_ce_plain
            return fn(logits.permute(0, 2, 3, 1), target, ignore_idx=self.ignore_idx,
                      label_smoothing=self.label_smoothing, class_wts=wts)
        loss, valid = pixel_ce(logits.permute(0, 2, 3, 1), target, wts, self.ignore_idx,
                               self.label_smoothing)
        return loss.sum() / valid.sum(dtype=torch.float32).clamp(min=1.0)

    def __call__(self, input_sample: Any, prediction: Any, target: torch.Tensor,
                 **kwargs) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        if isinstance(prediction, dict) and "segmentation_output" in prediction:
            main = self._ce(prediction["segmentation_output"], target)
            if "aux_output" in prediction:
                aux = self._ce(prediction["aux_output"], target)
                return {"total_loss": main + self.aux_wt * aux, "seg_loss": main,
                        "aux_loss": aux}
            return main
        return self._ce(prediction, target)
