"""Host-tier transforms (counterpart of cvnets_tpu/data/transforms/__init__.py).

Two tiers, as in the JAX package: the host tier (here) crops, flips and resizes
each sample in the loader's worker threads; the device tier
(``cvnets_tpu_torch/ops/image_ops.py`` and ``ops/mixing.py``) augments whole
batches on the card inside the train step.
"""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.utils.registry import Registry

TRANSFORMATIONS_REGISTRY = Registry(registry_name="torch_transforms")


def arguments_augmentation(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    from cvnets_tpu_torch.ops.image_ops import arguments_device_augmentation
    from cvnets_tpu_torch.ops.mixing import arguments_mixing

    from cvnets_tpu_torch.data.transforms.image import arguments_unported_transforms

    parser = arguments_mixing(parser)
    parser = arguments_device_augmentation(parser)
    parser = arguments_unported_transforms(parser)
    return TRANSFORMATIONS_REGISTRY.all_arguments(parser)


# registers the ported transforms (after TRANSFORMATIONS_REGISTRY exists)
from cvnets_tpu_torch.data.transforms import (  # noqa: E402,F401
    audio,
    audio_bytes,
    image,
    image_advanced,
    image_bytes,
)
