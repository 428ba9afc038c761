"""Base loss criteria (counterpart of cvnets_tpu/loss/base_criteria.py).

A loss is a callable ``loss(input_sample, prediction, target, training=...)``
returning a scalar tensor."""

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
