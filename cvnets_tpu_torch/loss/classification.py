"""Classification losses (counterpart of cvnets_tpu/loss/classification.py):
cross-entropy with integer or soft targets (mixup, cutmix). A dict prediction
(a model with RangeAugment's augmentor, in training) gives its ``logits``, as
in the JAX package (classification.py:78, 100). Class weights are not
ported."""

from __future__ import annotations

import argparse
from typing import Any

import torch
import torch.nn.functional as F

from cvnets_tpu_torch.loss import LOSS_REGISTRY
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria


@LOSS_REGISTRY.register(name="__base__", type="classification")
class BaseClassificationCriteria(BaseCriteria):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseClassificationCriteria:
            return parser
        group = parser.add_argument_group(title="Classification loss arguments")
        group.add_argument("--loss.classification.name", type=str, default="cross_entropy")
        return parser


@LOSS_REGISTRY.register(name="cross_entropy", type="classification")
class CrossEntropy(BaseClassificationCriteria):
    """Softmax CE with label smoothing, in float32 (classification.py:53-79).
    Integer targets: (1 - ls)·CE(one-hot) + ls·CE(uniform), mean over targets !=
    ignore_index. Soft targets (a row a sample): CE against
    ``soft·(1 - ls) + ls / C``, mean over the batch."""

    def __init__(self, opts) -> None:
        super().__init__(opts)
        self.label_smoothing = getattr(
            opts, "loss.classification.cross_entropy.label_smoothing", 0.0) or 0.0
        self.ignore_idx = getattr(opts, "loss.classification.cross_entropy.ignore_index", -1)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--loss.classification.cross-entropy.label-smoothing",
                           type=float, default=0.0)
        group.add_argument("--loss.classification.cross-entropy.ignore-index",
                           type=int, default=-1)
        return parser

    def __call__(self, input_sample: Any, prediction: torch.Tensor,
                 target: torch.Tensor, training: bool = True, **kwargs) -> torch.Tensor:
        ls = self.label_smoothing if training else 0.0
        if isinstance(prediction, dict):
            prediction = prediction["logits"]
        if target.dim() == prediction.dim():  # soft targets, smoothed to soft·(1 - ls) + ls / C
            return F.cross_entropy(prediction.float(), target.float(), label_smoothing=ls)
        return F.cross_entropy(prediction.float(), target,
                               ignore_index=self.ignore_idx,
                               label_smoothing=ls)
