"""Anchor generator registry (counterpart of cvnets_tpu/models/anchor_generator/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.utils.registry import Registry

ANCHOR_GEN_REGISTRY = Registry(registry_name="torch_anchor_gen")


def arguments_anchor_gen(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Anchor generator")
    group.add_argument("--anchor-generator.name", type=str, default=None)
    return ANCHOR_GEN_REGISTRY.all_arguments(parser)


def build_anchor_generator(opts, *args, **kwargs):
    return ANCHOR_GEN_REGISTRY[getattr(opts, "anchor_generator.name")](opts, *args, **kwargs)


# registers the ported generators (after ANCHOR_GEN_REGISTRY exists)
from cvnets_tpu_torch.models.anchor_generator import ssd_anchor_generator  # noqa: E402,F401
