"""Loss registry (counterpart of cvnets_tpu/loss/__init__.py).

``loss.category: composite_loss`` builds the weighted sum of the yaml list
``loss.composite_loss`` (``composite_loss.py``); any other category builds
``loss.<category>.name``. A loss that builds a model (distillation's teacher)
builds it on ``device``, the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import argparse
from typing import Union

import torch

from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.registry import Registry
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria

LOSS_REGISTRY = Registry(registry_name="torch_loss", base_class=BaseCriteria)


def add_loss_fn_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Loss function arguments")
    group.add_argument(
        "--loss.category", type=str, default="classification",
        help="Loss function category (classification, segmentation, detection, ...)",
    )
    return LOSS_REGISTRY.all_arguments(parser)


def build_loss_fn(opts, category: str = "",
                  device: Union[str, torch.device] = "cuda") -> BaseCriteria:
    """Build the loss selected by ``loss.category`` / ``loss.<category>.name``."""
    if not category:
        category = getattr(opts, "loss.category")
    if category == "composite_loss":
        loss_fn_name = "composite_loss"
    else:
        loss_fn_name = getattr(opts, f"loss.{category}.name", None)
    if loss_fn_name is None:
        logger.error(f"loss.{category}.name is not set")
    cls = LOSS_REGISTRY[loss_fn_name, category]
    return cls(opts, device=device) if getattr(cls, "TAKES_DEVICE", False) else cls(opts)


# registers the ported losses (after LOSS_REGISTRY exists)
from cvnets_tpu_torch.loss import (  # noqa: E402,F401
    classification,
    composite_loss,
    detection,
    distillation,
    multi_modal,
    neural_augmentation,
    segmentation,
)
