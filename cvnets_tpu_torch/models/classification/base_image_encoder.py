"""Base of the classification backbones (counterpart of
cvnets_tpu/models/classification/base_image_encoder.py).

NCHW input; the five-stage skeleton ``conv_1, layer_1..layer_5, classifier``. The
tap points, gradient checkpointing, dilation and the neural augmentor are not
ported yet.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.layers.pool import global_pool
from cvnets_tpu_torch.models import MODEL_REGISTRY


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
        return parser

    @classmethod
    def build_model(cls, opts) -> "BaseImageEncoder":
        return cls(opts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.STAGES:
            x = getattr(self, name)(x)
        return self.classifier(x)


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
