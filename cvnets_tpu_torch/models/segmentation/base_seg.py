"""Base segmentation model (counterpart of cvnets_tpu/models/segmentation/base_seg.py):
the ``--model.segmentation.*`` flags, with the JAX package's dests and defaults,
and the LR multiplier of the head."""

from __future__ import annotations

import argparse
from typing import Dict

import torch.nn as nn

from cvnets_tpu_torch.models import MODEL_REGISTRY


@MODEL_REGISTRY.register(name="__base__", type="segmentation")
class BaseSegmentation(nn.Module):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseSegmentation:
            return parser
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.segmentation.name", type=str, default=None)
        group.add_argument("--model.segmentation.n-classes", type=int, default=21)
        group.add_argument("--model.segmentation.pretrained", type=str, default=None)
        group.add_argument("--model.segmentation.lr-multiplier", type=float, default=1.0)
        group.add_argument("--model.segmentation.classifier-dropout", type=float,
                           default=0.1)
        group.add_argument("--model.segmentation.use-aux-head", action="store_true")
        group.add_argument("--model.segmentation.aux-dropout", type=float, default=0.1)
        group.add_argument("--model.segmentation.norm-layer", type=str, default=None,
                           help="Norm layer for the segmentation head only")
        group.add_argument("--model.segmentation.output-stride", type=int, default=None)
        group.add_argument("--model.segmentation.replace-stride-with-dilation",
                           action="store_true")
        group.add_argument("--model.segmentation.activation.name", type=str, default=None)
        group.add_argument("--model.segmentation.activation.inplace", action="store_true")
        group.add_argument("--model.segmentation.activation.neg-slope", type=float,
                           default=0.1)
        group.add_argument("--model.segmentation.seg-head", type=str, default="deeplabv3")
        group.add_argument("--model.segmentation.freeze-batch-norm", action="store_true")
        group.add_argument("--model.segmentation.use-level5-exp", action="store_true")
        group.add_argument("--model.segmentation.upsample-train-logits", action="store_true",
                           help="Upsample the logits to the input size in training too; "
                                "by default the loss fuses resize and CE")
        return parser

    @classmethod
    def build_model(cls, opts) -> "BaseSegmentation":
        return cls(opts)

    def __init__(self, opts) -> None:
        super().__init__()
        self.n_seg_classes = getattr(opts, "model.segmentation.n_classes", 21)

    @staticmethod
    def get_lr_multipliers(opts) -> Dict[str, float]:
        """Regex over parameter names → LR multiplier (base_seg.py:65-70)."""
        mult = getattr(opts, "model.segmentation.lr_multiplier", 1.0)
        return {} if mult == 1.0 else {r"seg_head": mult}
