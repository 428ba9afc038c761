"""Text-encoder registry (counterpart of
cvnets_tpu/models/multi_modal/text_encoders/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.utils.registry import Registry

TEXT_ENCODER_REGISTRY = Registry(registry_name="torch_text_encoder")


def arguments_text_encoder(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Text encoder")
    group.add_argument("--model.text.name", type=str, default=None)
    return TEXT_ENCODER_REGISTRY.all_arguments(parser)


def build_text_encoder(opts, projection_dim: int):
    name = getattr(opts, "model.text.name", None) or "transformer"
    return TEXT_ENCODER_REGISTRY[name](opts, projection_dim=projection_dim)


# registers the ported text encoders (after TEXT_ENCODER_REGISTRY exists)
from cvnets_tpu_torch.models.multi_modal.text_encoders import transformer  # noqa: E402,F401
