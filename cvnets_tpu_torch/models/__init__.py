"""Model registry and builder (counterpart of cvnets_tpu/models/__init__.py)."""

from __future__ import annotations

import argparse
from typing import Optional, Union

import torch
import torch.nn as nn

from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.registry import Registry

MODEL_REGISTRY = Registry(registry_name="torch_model_registry", base_class=nn.Module)


def get_model(opts, category: Optional[str] = None, model_name: Optional[str] = None,
              generator: Optional[torch.Generator] = None,
              device: Union[str, torch.device] = "cuda") -> nn.Module:
    """Build the model selected by ``dataset.category`` / ``model.<cat>.name`` on
    ``device`` (the CUDA card unless the caller asks for the CPU), initialised
    from ``generator`` (default: a CPU generator seeded with ``common.seed``, so
    one seed gives the same weights on every device). Raises when the device
    is a CUDA one and no card is present.

    A top-level classification model of a family that has one gets the
    neural augmentor of ``--model.learn-augmentation.*``; any other model
    asked for one is built without it, with a warning, as the JAX package
    builds none there."""
    from cvnets_tpu_torch.layers.init_utils import init_weights
    from cvnets_tpu_torch.models.neural_augmentor.neural_aug import build_neural_augmentor

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("get_model: no CUDA device is available; pass "
                           "device='cpu' to build the model on the CPU")
    if category is None:
        category = getattr(opts, "dataset.category")
    if model_name is None:
        model_name = getattr(opts, f"model.{category}.name")
    if model_name == "__base__":
        logger.error(f"For {category} task, model name can't be __base__.")
    if getattr(opts, f"model.{category}.freeze_batch_norm", False):
        # the norm factory builds frozen batch norms and the optimizer leaves the
        # norms' parameters out (models/__init__.py:34-40)
        setattr(opts, "model.normalization.frozen", True)
        logger.info(f"Normalization layers are frozen ({category})")
    model = MODEL_REGISTRY[model_name, category].build_model(opts)
    mode = getattr(opts, "model.learn_augmentation.mode", None)
    if category == "classification" and getattr(model, "NEURAL_AUGMENTOR", False):
        augmentor = build_neural_augmentor(opts)
        if augmentor is not None:
            model.neural_augmentor = augmentor
    elif mode is not None:
        logger.warning(f"--model.learn-augmentation.mode {mode}: the {category} model "
                       f"{model_name} builds no neural augmentor, as in the JAX package "
                       "(which never runs it there); its neural_augmentation loss is 0")
    if generator is None:
        generator = torch.Generator().manual_seed(getattr(opts, "common.seed", 0) or 0)
    init_weights(model, opts, generator)
    return model.to(device)


def arguments_finetune_scopes(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The scope surgery of ``--common.finetune`` (cvnets_tpu/models/base_model.py:32-44;
    ``utils/checkpoint_utils.finetune_weights`` applies it)."""
    group = parser.add_argument_group(title="Model arguments (common)")
    group.add_argument("--model.resume-exclude-scopes", type=str, default="",
                       help="Comma-separated regexes of the tensors that keep their fresh "
                            "values when a finetune checkpoint is loaded")
    group.add_argument("--model.ignore-missing-scopes", type=str, default="",
                       help="Comma-separated regexes of the tensors a finetune checkpoint "
                            "may lack without a warning")
    group.add_argument("--model.rename-scopes-map", type=str, nargs="*", default=None,
                       help="from:to regex renames applied to a finetune checkpoint's keys")
    return parser


def modeling_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    from cvnets_tpu_torch.layers import layer_specific_arguments
    from cvnets_tpu_torch.misc.averaging_utils import arguments_ema
    from cvnets_tpu_torch.models.anchor_generator import arguments_anchor_gen
    from cvnets_tpu_torch.models.matcher_det import arguments_box_matcher
    from cvnets_tpu_torch.models.multi_modal.image_projection import (
        arguments_image_projection_head,
    )
    from cvnets_tpu_torch.models.multi_modal.text_encoders import arguments_text_encoder
    from cvnets_tpu_torch.models.neural_augmentor import arguments_neural_augmentor
    from cvnets_tpu_torch.options.utils import extend_selected_args_with_prefix

    parser = arguments_finetune_scopes(parser)
    parser = MODEL_REGISTRY.all_arguments(parser)
    parser = arguments_text_encoder(parser)
    parser = arguments_image_projection_head(parser)
    parser = layer_specific_arguments(parser)
    parser = arguments_ema(parser)
    parser = arguments_anchor_gen(parser)
    parser = arguments_box_matcher(parser)
    parser = arguments_neural_augmentor(parser)
    # distillation's teacher: every --model.* flag cloned, last, as in
    # cvnets_tpu/models/__init__.py:71-73
    return extend_selected_args_with_prefix(parser, "--model.", "--teacher.model.")


# registers the ported models (after MODEL_REGISTRY exists)
from cvnets_tpu_torch.models.classification import (  # noqa: E402,F401
    byteformer,
    efficientnet,
    fastvit,
    mobilenetv1,
    mobilenetv2,
    mobilenetv3,
    mobileone,
    mobilevit,
    mobilevit_v2,
    regnet,
    resnet,
    swin_transformer,
    vit,
)
from cvnets_tpu_torch.models.detection import base_detection, mask_rcnn, ssd  # noqa: E402,F401
from cvnets_tpu_torch.models.multi_modal import base_multi_modal, clip  # noqa: E402,F401
from cvnets_tpu_torch.models.segmentation import enc_dec  # noqa: E402,F401
from cvnets_tpu_torch.models.segmentation.heads import seg_heads  # noqa: E402,F401
from cvnets_tpu_torch.models.video_classification import spatio_temporal  # noqa: E402,F401
