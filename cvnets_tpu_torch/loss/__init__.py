"""Loss registry (counterpart of cvnets_tpu/loss/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu.utils import logger
from cvnets_tpu.utils.registry import Registry
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria

LOSS_REGISTRY = Registry(registry_name="torch_loss", base_class=BaseCriteria)


def add_loss_fn_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Loss function arguments")
    group.add_argument(
        "--loss.category", type=str, default="classification",
        help="Loss function category (classification, segmentation, detection, ...)",
    )
    return LOSS_REGISTRY.all_arguments(parser)


def build_loss_fn(opts, category: str = "") -> BaseCriteria:
    """Build the loss selected by ``loss.category`` / ``loss.<category>.name``."""
    if not category:
        category = getattr(opts, "loss.category")
    loss_fn_name = getattr(opts, f"loss.{category}.name", None)
    if loss_fn_name is None:
        logger.error(f"loss.{category}.name is not set")
    return LOSS_REGISTRY[loss_fn_name, category](opts)


# registers the ported losses (after LOSS_REGISTRY exists)
from cvnets_tpu_torch.loss import classification  # noqa: E402,F401
