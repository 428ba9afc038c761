"""Box matcher registry (counterpart of cvnets_tpu/models/matcher_det/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.utils.registry import Registry

MATCHER_REGISTRY = Registry(registry_name="torch_matcher")


def arguments_box_matcher(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Box matcher")
    group.add_argument("--matcher.name", type=str, default=None)
    return MATCHER_REGISTRY.all_arguments(parser)


def build_matcher(opts, *args, **kwargs):
    return MATCHER_REGISTRY[getattr(opts, "matcher.name")](opts, *args, **kwargs)


# registers the ported matchers (after MATCHER_REGISTRY exists)
from cvnets_tpu_torch.models.matcher_det import ssd_matcher  # noqa: E402,F401
