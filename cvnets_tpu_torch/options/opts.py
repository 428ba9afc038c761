"""Argument aggregation over the port's registries (counterpart of
cvnets_tpu/options/opts.py:158-169, which imports the flax registries).

Flag names, dests and defaults are those of the JAX parser; only the flags of the
ported slice are registered, so a yaml key the port cannot honour yet is reported
by ``load_config_file`` instead of being silently accepted.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from cvnets_tpu_torch.options.parse_args import ParseKwargs
from cvnets_tpu_torch.options.utils import load_config_file


def arguments_common(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Common arguments")
    group.add_argument("--taskname", type=str, default="", help="Task name (free-form)")
    group.add_argument("--common.seed", type=int, default=0, help="Random seed")
    group.add_argument("--common.config-file", type=str, default=None)
    group.add_argument("--common.mixed-precision", action="store_true")
    group.add_argument(
        "--common.mixed-precision-dtype", type=str, default="bfloat16",
        choices=["float16", "bfloat16", "float32"],
        help="Autocast dtype under mixed precision; parameters stay float32",
    )
    group.add_argument("--common.grad-clip", type=float, default=None)
    group.add_argument(
        "--common.override-kwargs", nargs="*", action=ParseKwargs,
        help="Override config entries, e.g. sampler.bs.crop_size_width=512",
    )
    return parser


def arguments_dataset(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The dataset and sampler flags the train step reads (the data pipeline
    itself is not ported yet; cvnets_tpu/data/datasets/dataset_base.py:51-52,
    data/sampler/batch_sampler.py:32-35)."""
    group = parser.add_argument_group(title="Dataset arguments")
    group.add_argument("--dataset.category", type=str, default="classification")
    group.add_argument("--dataset.train-batch-size0", type=int, default=128)
    group.add_argument("--sampler.bs.crop-size-width", type=int, default=256)
    group.add_argument("--sampler.bs.crop-size-height", type=int, default=256)
    return parser


def get_training_arguments(parse_args: bool = True, args: Optional[List[str]] = None):
    from cvnets_tpu_torch.loss import add_loss_fn_arguments
    from cvnets_tpu_torch.models import modeling_arguments
    from cvnets_tpu_torch.optim import arguments_optimizer
    from cvnets_tpu_torch.optim.scheduler import arguments_scheduler

    parser = argparse.ArgumentParser(description="Training arguments (PyTorch port)")
    parser = arguments_dataset(parser)
    parser = modeling_arguments(parser)
    parser = add_loss_fn_arguments(parser)
    parser = arguments_optimizer(parser)
    parser = arguments_scheduler(parser)
    parser = arguments_common(parser)
    if parse_args:
        return load_config_file(parser.parse_args(args))
    return parser
