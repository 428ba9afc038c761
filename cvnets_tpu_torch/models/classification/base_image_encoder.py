"""Base of the classification backbones (counterpart of
cvnets_tpu/models/classification/base_image_encoder.py).

NCHW input; the five-stage skeleton ``conv_1, layer_1..layer_5, conv_1x1_exp,
classifier`` (a model without ``conv_1x1_exp`` goes from layer_5 to the
classifier), ``extract_features`` (the stages without the classifier: CLIP's
image features), and the tap points that the segmentation heads read
(``extract_end_points_all``). Gradient checkpointing is not ported yet, and a
model whose options ask for the neural augmentor (RangeAugment,
``--model.learn-augmentation.mode``) raises: it waits for ROADMAP.md queue 1
item 12.

As in the JAX package, ``--model.classification.activation.*`` are parsed and
never read: the JAX package never calls its
``set_model_specific_opts_before_model_building`` (base_image_encoder.py:258),
so the layers build with ``--model.activation.*``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.layers.pool import global_pool
from cvnets_tpu_torch.models import MODEL_REGISTRY


def dilates(output_stride: Optional[int], stage: int) -> bool:
    """Whether stage 4 or 5 (output strides 16 and 32) turns its stride 2 into
    dilation for an encoder at ``output_stride`` (8 or 16; None: no stage)."""
    return output_stride is not None and {4: 16, 5: 32}.get(stage, 0) > output_stride


@MODEL_REGISTRY.register(name="__base__", type="classification")
class BaseImageEncoder(nn.Module):
    STAGES = ("conv_1", "layer_1", "layer_2", "layer_3", "layer_4", "layer_5")

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseImageEncoder:
            return parser
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.classifier-dropout", type=float,
                           default=0.0)
        group.add_argument("--model.classification.name", type=str, default=None)
        group.add_argument("--model.classification.n-classes", type=int, default=1000)
        group.add_argument("--model.classification.pretrained", type=str, default=None)
        group.add_argument("--model.classification.activation.name", type=str, default=None)
        group.add_argument("--model.classification.activation.inplace", action="store_true")
        group.add_argument("--model.classification.activation.neg-slope", type=float,
                           default=0.1)
        group = parser.add_argument_group(title="Neural augmentor")
        group.add_argument("--model.learn-augmentation.mode", type=str, default=None,
                           help="RangeAugment's augmentor; not ported, a model refuses it")
        return parser

    @classmethod
    def build_model(cls, opts, **kwargs) -> "BaseImageEncoder":
        """``kwargs``: e.g. ``output_stride`` for a segmentation encoder."""
        if getattr(opts, "model.learn_augmentation.mode", None) is not None:
            raise NotImplementedError(
                "not ported yet: the neural augmentor (RangeAugment, "
                "--model.learn-augmentation.*) waits for ROADMAP.md queue 1 item 12")
        return cls(opts, **kwargs)

    @staticmethod
    def n_classes(opts) -> int:
        return getattr(opts, "model.classification.n_classes", 1000)

    @staticmethod
    def classifier_dropout(opts) -> float:
        return getattr(opts, "model.classification.classifier_dropout", 0.0) or 0.0

    @staticmethod
    def get_lr_multipliers(opts) -> Dict[str, float]:
        """No per-parameter LR multipliers (layer-wise LR decay, the JAX
        encoders' only multiplier, is not ported)."""
        return {}

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """``conv_1`` … ``layer_5``, then ``conv_1x1_exp`` where the model has
        one (base_image_encoder.py:196-200)."""
        for name in self.STAGES:
            x = getattr(self, name)(x)
        exp = getattr(self, "conv_1x1_exp", None)
        return x if exp is None else exp(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.extract_features(x))

    def extract_end_points_all(self, x: torch.Tensor, use_l5: bool = True,
                               use_l5_exp: bool = False) -> Dict[str, torch.Tensor]:
        """Features after layer_1..layer_5 as ``out_l1``..``out_l5``
        (base_image_encoder.py:167-191); ``out_l5_exp`` after ``conv_1x1_exp``,
        which a model without one passes through."""
        out: Dict[str, torch.Tensor] = {}
        x = self.conv_1(x)
        for i in range(1, 6 if use_l5 else 5):
            x = getattr(self, f"layer_{i}")(x)
            out[f"out_l{i}"] = x
        if use_l5 and use_l5_exp:
            exp = getattr(self, "conv_1x1_exp", None)
            out["out_l5_exp"] = x if exp is None else exp(x)
        return out

    def extract_end_points_l4(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.extract_end_points_all(x, use_l5=False)


class Classifier(nn.Module):
    """GlobalPool → Dropout → Linear head."""

    def __init__(self, opts, in_features: int, n_classes: int,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.pool_type = getattr(opts, "model.layer.global_pool", "mean")
        self.dropout = nn.Dropout(dropout)
        self.fc = LinearLayer(in_features, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.dropout(global_pool(x, self.pool_type)))
