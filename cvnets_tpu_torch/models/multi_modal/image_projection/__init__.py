"""Image projection head registry (counterpart of
cvnets_tpu/models/multi_modal/image_projection/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.utils.registry import Registry

IMAGE_PROJECTION_HEAD_REGISTRY = Registry(registry_name="torch_image_projection_head")


def arguments_image_projection_head(parser: argparse.ArgumentParser
                                    ) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Image projection head")
    group.add_argument("--model.image-projection-head.name", type=str, default=None)
    return IMAGE_PROJECTION_HEAD_REGISTRY.all_arguments(parser)


def build_image_projection_head(opts, in_dim: int, out_dim: int):
    name = getattr(opts, "model.image_projection_head.name", None) or "global_pool_nchw2nc"
    return IMAGE_PROJECTION_HEAD_REGISTRY[name](opts, in_dim=in_dim, out_dim=out_dim)


# registers the ported heads (after IMAGE_PROJECTION_HEAD_REGISTRY exists)
from cvnets_tpu_torch.models.multi_modal.image_projection import heads  # noqa: E402,F401
