"""Base detection model (counterpart of cvnets_tpu/models/detection/base_detection.py):
the ``--model.detection.*`` and ``--evaluation.detection.*`` flags, with the
JAX package's dests and defaults, and the encoder: the registered
classification model, dilated for ``--model.detection.output-stride`` 8 or
16, without its classifier (a detector never calls it, so the flax tree has
none)."""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch.nn as nn

from cvnets_tpu_torch.models import MODEL_REGISTRY


@MODEL_REGISTRY.register(name="__base__", type="detection")
class BaseDetection(nn.Module):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseDetection:
            return parser
        group = parser.add_argument_group(title="Detection models (common)")
        group.add_argument("--model.detection.name", type=str, default=None)
        group.add_argument("--model.detection.n-classes", type=int, default=80)
        group.add_argument("--model.detection.pretrained", type=str, default=None)
        group.add_argument("--model.detection.output-stride", type=int, default=None)
        group.add_argument("--model.detection.replace-stride-with-dilation",
                           action="store_true", default=False)
        group.add_argument("--model.detection.freeze-batch-norm", action="store_true",
                           default=False)
        group.add_argument("--evaluation.detection.mode", type=str, default="validation_set",
                           choices=["single_image", "image_folder", "validation_set"])
        group.add_argument("--evaluation.detection.path", type=str, default=None)
        group.add_argument("--evaluation.detection.num-classes-in-dataset", type=int,
                           default=None)
        group.add_argument("--evaluation.detection.num-classes", type=int, default=None,
                           help="Config-compat: detection class count for offline eval")
        group.add_argument("--evaluation.detection.resize-input-images", action="store_true",
                           default=False)
        group.add_argument("--evaluation.detection.save-overlay-boxes", action="store_true")
        return parser

    @classmethod
    def build_model(cls, opts) -> "BaseDetection":
        return cls(opts)

    @staticmethod
    def build_encoder(opts, output_stride: Optional[int] = None) -> nn.Module:
        if output_stride is None:
            output_stride = getattr(opts, "model.detection.output_stride", None)
        kwargs = {"output_stride": output_stride} if output_stride in (8, 16) else {}
        name = getattr(opts, "model.classification.name")
        encoder = MODEL_REGISTRY[name, "classification"].build_model(opts, **kwargs)
        encoder.classifier = None
        return encoder

    @staticmethod
    def get_lr_multipliers(opts) -> Dict[str, float]:
        return {}

