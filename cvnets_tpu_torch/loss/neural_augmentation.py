"""RangeAugment's loss (counterpart of cvnets_tpu/loss/neural_augmentation.py).

``alpha / 65025 · mean(smooth-L1(per-image MSE · 255², target MSE))``: each
image's MSE between the augmentor's output and the model's input, on the
0-255 scale, pulled towards a target MSE that a PSNR curriculum (``cosine``
or ``linear`` from the first target value to the last, default 40 → 20 dB)
sets by the step: the iteration over ``scheduler.max_iterations`` when the
scheduler is iteration based, else the epoch over ``scheduler.max_epochs``.
Without an ``augmented_tensor`` in the prediction (evaluation, a model
without the augmentor, CLIP's dict) the loss is 0. Float32 on the
prediction's device; a step given as a device tensor stays there (nothing is
read back). The loss runs inside a ``torch.profiler`` range named
``NA_LOSS_RANGE``."""

from __future__ import annotations

import argparse
import math
from typing import Any, Union

import numpy as np
import torch
from torch.profiler import record_function

from cvnets_tpu_torch.loss import LOSS_REGISTRY
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria
from cvnets_tpu_torch.utils import logger

MAX_MSE = 65025.0  # mean((255 - 0)^2)
NA_LOSS_RANGE = "neural_augmentation_loss"


def psnr_to_mse(psnr: float) -> float:
    return 10.0 ** ((20.0 * math.log10(255.0) - psnr) / 10.0)


def smooth_l1(pred: torch.Tensor, target: Union[torch.Tensor, float],
              beta: float = 1.0) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


def first_tensor(tree: Any) -> torch.Tensor:
    """The first tensor of a dict tree (or the tensor itself)."""
    if isinstance(tree, torch.Tensor):
        return tree
    for value in (tree.values() if isinstance(tree, dict) else ()):
        found = first_tensor(value)
        if found is not None:
            return found
    return None


def zero_loss(prediction: Any) -> torch.Tensor:
    """A float32 0 on the device of the first tensor of ``prediction``."""
    return first_tensor(prediction).new_zeros((), dtype=torch.float32)


@LOSS_REGISTRY.register(name="neural_augmentation", type="neural_augmentation")
class NeuralAugmentation(BaseCriteria):
    def __init__(self, opts) -> None:
        super().__init__(opts)
        metric = (getattr(opts, "loss.neural_augmentation.perceptual_metric", "psnr")
                  or "psnr").lower()
        if metric != "psnr":  # a yaml value bypasses the flag's choices
            logger.error(f"Supported perceptual metrics: ['psnr']. Got: {metric}")
        target = getattr(opts, "loss.neural_augmentation.target_value", [40, 20])
        if isinstance(target, (int, float)):
            target = [target, target]
        self.start_mse = psnr_to_mse(target[0])
        self.end_mse = psnr_to_mse(target[-1])
        self.curriculum = getattr(opts, "loss.neural_augmentation.curriculum_method", "cosine")
        self.alpha = (getattr(opts, "loss.neural_augmentation.alpha", 100.0) or 100.0) / MAX_MSE
        self.iteration_based = getattr(opts, "scheduler.is_iteration_based", False)
        if self.iteration_based:
            self.max_steps = getattr(opts, "scheduler.max_iterations", 10000)
        else:
            self.max_steps = getattr(opts, "scheduler.max_epochs", 100)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--loss.neural-augmentation.perceptual-metric", type=str,
                           default="psnr", choices=["psnr"])
        group.add_argument("--loss.neural-augmentation.target-value", type=float,
                           nargs="+", default=[40, 20])
        group.add_argument("--loss.neural-augmentation.curriculum-method", type=str,
                           default="cosine", choices=["linear", "cosine"])
        group.add_argument("--loss.neural-augmentation.alpha", type=float, default=100.0)
        return parser

    def target_mse(self, step) -> Union[torch.Tensor, float]:
        """The curriculum's MSE at ``step``, in float32: a device tensor for a
        tensor step, else a host number."""
        if isinstance(step, torch.Tensor):
            frac = torch.clamp(step.float() / self.max_steps, 0.0, 1.0)
            w = 0.5 * (1.0 + torch.cos(math.pi * frac)) if self.curriculum == "cosine" \
                else 1.0 - frac
        else:
            frac = np.clip(np.float32(step) / np.float32(self.max_steps), 0.0, 1.0)
            w = (np.float32(0.5) * (1 + np.cos(np.float32(np.pi) * frac))
                 if self.curriculum == "cosine" else np.float32(1.0) - frac)
        target = self.end_mse + (self.start_mse - self.end_mse) * w
        return target if isinstance(target, torch.Tensor) else float(np.float32(target))

    def __call__(self, input_sample: Any, prediction: Any, target: Any,
                 **kwargs) -> torch.Tensor:
        if not isinstance(prediction, dict) or prediction.get("augmented_tensor") is None:
            return zero_loss(prediction)
        augmented = prediction["augmented_tensor"]
        step = kwargs.get("iterations", 0) if self.iteration_based else kwargs.get("epoch", 0)
        with record_function(NA_LOSS_RANGE):
            sq_err = ((augmented.float() - input_sample.float()) * 255.0) ** 2
            pred_mse = sq_err.mean(dim=tuple(range(1, sq_err.dim())))
            return self.alpha * smooth_l1(pred_mse, self.target_mse(step)).mean()
