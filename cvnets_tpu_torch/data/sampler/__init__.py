"""Sampler registry (counterpart of cvnets_tpu/data/sampler/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.data.sampler.base_sampler import BaseSampler
from cvnets_tpu_torch.utils.registry import Registry

SAMPLER_REGISTRY = Registry(registry_name="torch_sampler", base_class=BaseSampler)


def add_sampler_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Sampler arguments")
    group.add_argument("--sampler.name", type=str, default="batch_sampler")
    group.add_argument("--sampler.use-shards", action="store_true", default=False)
    group.add_argument("--sampler.num-repeats", type=int, default=1,
                       help="Repeated augmentation factor")
    group.add_argument("--sampler.truncated-repeat-aug-sampler", action="store_true",
                       default=False)
    return SAMPLER_REGISTRY.all_arguments(parser)


def build_sampler(opts, n_data_samples: int, is_training: bool = False,
                  *args, **kwargs) -> BaseSampler:
    """The sampler named by ``sampler.name``; a ``*_ddp`` name is the same class
    (every sampler takes ``rank`` and ``num_replicas``)."""
    sampler_name = getattr(opts, "sampler.name", "batch_sampler")
    if sampler_name.endswith("_ddp"):
        sampler_name = sampler_name[: -len("_ddp")]
    return SAMPLER_REGISTRY[sampler_name](
        opts, n_data_samples=n_data_samples, is_training=is_training, *args, **kwargs)


# registers the ported samplers (after SAMPLER_REGISTRY exists)
from cvnets_tpu_torch.data.sampler import (  # noqa: E402,F401
    batch_sampler,
    chain_sampler,
    variable_batch_sampler,
)
