"""Base multi-modal image-text model (counterpart of
cvnets_tpu/models/multi_modal/base_multi_modal.py): the
``--model.multi-modal-image-text.*`` flags with the JAX package's dests."""

from __future__ import annotations

import argparse

import torch.nn as nn

from cvnets_tpu_torch.models import MODEL_REGISTRY


@MODEL_REGISTRY.register(name="__base__", type="multi_modal_image_text")
class BaseMultiModalImageText(nn.Module):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseMultiModalImageText:
            return parser
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.multi-modal-image-text.name", type=str, default=None)
        group.add_argument("--model.multi-modal-image-text.pretrained", type=str,
                           default=None)
        group.add_argument("--model.multi-modal-image-text.lr-multiplier-img-encoder",
                           type=float, default=1.0)
        group.add_argument("--model.multi-modal-image-text.lr-multiplier-text-encoder",
                           type=float, default=1.0)
        return parser

    @classmethod
    def build_model(cls, opts) -> "BaseMultiModalImageText":
        return cls(opts)
