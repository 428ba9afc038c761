"""Model registry and builder (counterpart of cvnets_tpu/models/__init__.py)."""

from __future__ import annotations

import argparse
from typing import Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.registry import Registry

MODEL_REGISTRY = Registry(registry_name="torch_model_registry", base_class=nn.Module)


def get_model(opts, category: Optional[str] = None, model_name: Optional[str] = None,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build the model selected by ``dataset.category`` / ``model.<cat>.name`` on
    the CPU, initialised from ``generator`` (default: seeded with
    ``common.seed``)."""
    from cvnets_tpu_torch.layers.init_utils import init_weights

    if category is None:
        category = getattr(opts, "dataset.category")
    if model_name is None:
        model_name = getattr(opts, f"model.{category}.name")
    if model_name == "__base__":
        logger.error(f"For {category} task, model name can't be __base__.")
    model = MODEL_REGISTRY[model_name, category].build_model(opts)
    if generator is None:
        generator = torch.Generator().manual_seed(getattr(opts, "common.seed", 0) or 0)
    init_weights(model, opts, generator)
    return model


def modeling_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    from cvnets_tpu_torch.layers import layer_specific_arguments
    from cvnets_tpu_torch.misc.averaging_utils import arguments_ema

    parser = MODEL_REGISTRY.all_arguments(parser)
    parser = layer_specific_arguments(parser)
    parser = arguments_ema(parser)
    return parser


# registers the ported models (after MODEL_REGISTRY exists)
from cvnets_tpu_torch.models.classification import mobilevit_v2, vit  # noqa: E402,F401
from cvnets_tpu_torch.models.segmentation import enc_dec  # noqa: E402,F401
from cvnets_tpu_torch.models.segmentation.heads import seg_heads  # noqa: E402,F401
