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
    group.add_argument("--common.results-loc", type=str, default="results")
    group.add_argument("--common.run-label", type=str, default="run_1")
    group.add_argument("--common.resume", type=str, default=None)
    group.add_argument("--common.finetune", type=str, default=None)
    group.add_argument("--common.finetune-ema", type=str, default=None)
    group.add_argument("--common.mixed-precision", action="store_true")
    group.add_argument(
        "--common.mixed-precision-dtype", type=str, default="bfloat16",
        choices=["float16", "bfloat16", "float32"],
        help="Autocast dtype under mixed precision; parameters stay float32",
    )
    group.add_argument("--common.accum-freq", type=int, default=1)
    group.add_argument("--common.accum-after-epoch", type=int, default=0)
    group.add_argument("--common.log-freq", type=int, default=100)
    group.add_argument("--common.profile-trace-dir", type=str, default=None)
    group.add_argument("--common.auto-resume", action="store_true")
    group.add_argument("--common.grad-clip", type=float, default=None)
    group.add_argument("--common.k-best-checkpoints", type=int, default=5)
    group.add_argument("--common.save-all-checkpoints", action="store_true", default=False)
    group.add_argument("--common.save-interval-freq", type=int, default=0)
    group.add_argument(
        "--common.override-kwargs", nargs="*", action=ParseKwargs,
        help="Override config entries, e.g. sampler.bs.crop_size_width=512",
    )
    return parser


def get_training_arguments(parse_args: bool = True, args: Optional[List[str]] = None):
    from cvnets_tpu_torch.data.datasets import arguments_dataset
    from cvnets_tpu_torch.data.sampler import add_sampler_arguments
    from cvnets_tpu_torch.data.transforms import arguments_augmentation
    from cvnets_tpu_torch.loss import add_loss_fn_arguments
    from cvnets_tpu_torch.metrics import arguments_stats
    from cvnets_tpu_torch.models import modeling_arguments
    from cvnets_tpu_torch.optim import arguments_optimizer
    from cvnets_tpu_torch.optim.scheduler import arguments_scheduler

    parser = argparse.ArgumentParser(description="Training arguments (PyTorch port)")
    parser = arguments_dataset(parser)
    parser = add_sampler_arguments(parser)
    parser = arguments_augmentation(parser)
    parser = modeling_arguments(parser)
    parser = add_loss_fn_arguments(parser)
    parser = arguments_optimizer(parser)
    parser = arguments_scheduler(parser)
    parser = arguments_common(parser)
    parser = arguments_stats(parser)
    if parse_args:
        return load_config_file(parser.parse_args(args))
    return parser


def get_eval_arguments(parse_args: bool = True, args: Optional[List[str]] = None):
    """The evaluation flags are the training flags, as in the JAX package."""
    return get_training_arguments(parse_args=parse_args, args=args)
