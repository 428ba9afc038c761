"""Base loss criteria (counterpart of cvnets_tpu/loss/base_criteria.py).

A loss is a callable ``loss(input_sample, prediction, target, training=...)``
returning a scalar tensor, or a dict of them with the total under
``total_loss``."""

from __future__ import annotations

import argparse
from typing import Any

import torch


class BaseCriteria:
    def __init__(self, opts) -> None:
        self.opts = opts

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        return parser

    def __call__(self, input_sample: Any, prediction: Any, target: Any,
                 **kwargs) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    @staticmethod
    def _class_weights(target: torch.Tensor, n_classes: int,
                       norm_val: float = 1.1) -> torch.Tensor:
        """Inverse-log-frequency class weights 1 / log(count / total + norm_val)
        from the target histogram (base_criteria.py:33-39); labels outside
        [0, n_classes) are not counted. (No ``torch.bincount``: on a CUDA tensor
        it reads the largest label back to the host.)"""
        idx = target.reshape(-1)
        idx = torch.where((idx >= 0) & (idx < n_classes), idx, n_classes)  # a spill bin
        counts = torch.zeros(n_classes + 1, dtype=torch.int64, device=target.device
                             ).scatter_add_(0, idx, torch.ones_like(idx))[:n_classes]
        total = counts.sum().clamp(min=1)
        return 1.0 / torch.log(counts.float() / total + norm_val)
