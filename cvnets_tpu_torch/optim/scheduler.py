"""Warmup-cosine LR scheduler: a copy of the cosine scheduler of
cvnets_tpu/optim/scheduler.py, which cannot be imported without jax and optax
(importing it runs cvnets_tpu/optim/__init__.py).

Stateless: ``retrieve_lr(epoch, curr_iter)`` recomputes the LR each iteration and
rounds it to 8 places, the reference's semantics.
"""

from __future__ import annotations

import argparse
import math

from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.registry import Registry

SCHEDULER_REGISTRY = Registry(registry_name="torch_scheduler")

ROUND_PLACES = 8


class BaseLRScheduler:
    def __init__(self, opts) -> None:
        self.opts = opts
        self.round_places = ROUND_PLACES
        self.warmup_iterations = max(getattr(opts, "scheduler.warmup_iterations", 0) or 0, 0)
        warmup_init_lr = getattr(opts, "scheduler.warmup_init_lr", 1e-7)
        self.warmup_init_lr = warmup_init_lr if warmup_init_lr is not None else 1e-7
        # epoch-based schedules may shift their period past the warmup epochs
        # (reference base_scheduler.py:27-31); warmup_epochs is the last epoch
        # seen inside warmup (reference cosine.py:66)
        self.adjust_period = getattr(opts, "scheduler.adjust_period_for_epochs", False)
        self.warmup_epochs = 0

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        return parser

    def get_lr(self, epoch: int, curr_iter: int) -> float:
        raise NotImplementedError

    def retrieve_lr(self, epoch: int, curr_iter: int) -> float:
        return round(self.get_lr(epoch, curr_iter), self.round_places)

    def _warmup_lr(self, curr_iter: int, max_lr: float) -> float:
        step = (max_lr - self.warmup_init_lr) / max(self.warmup_iterations, 1)
        return self.warmup_init_lr + curr_iter * step


@SCHEDULER_REGISTRY.register("cosine")
class CosineScheduler(BaseLRScheduler):
    """Cosine annealing with linear warmup (reference optim/scheduler/cosine.py:14)."""

    def __init__(self, opts) -> None:
        super().__init__(opts)
        self.max_lr = getattr(opts, "scheduler.cosine.max_lr", 0.1)
        self.min_lr = getattr(opts, "scheduler.cosine.min_lr", 1e-5)
        self.is_iter_based = getattr(opts, "scheduler.is_iteration_based", True)
        self.max_iterations = getattr(opts, "scheduler.max_iterations", 150000)
        self.max_epochs = getattr(opts, "scheduler.max_epochs", 350)
        if self.is_iter_based:
            self.period = self.max_iterations - self.warmup_iterations + 1
        else:
            self.period = self.max_epochs

    @classmethod
    def add_arguments(cls, parser):
        group = parser.add_argument_group(title="Cosine LR scheduler")
        group.add_argument("--scheduler.cosine.max-lr", type=float, default=0.1)
        group.add_argument("--scheduler.cosine.min-lr", type=float, default=1e-5)
        return parser

    def get_lr(self, epoch: int, curr_iter: int) -> float:
        if curr_iter < self.warmup_iterations:
            self.warmup_epochs = epoch
            return self._warmup_lr(curr_iter, self.max_lr)
        if self.is_iter_based:
            adjust = min(max(curr_iter - self.warmup_iterations, 0), self.period)
            period = self.period
        else:
            # unclamped, as the reference (cosine.py:71-78): right after warmup
            # the phase is negative and cos is even, so the LR restarts at max_lr
            adjust = epoch - (self.warmup_epochs + 1 if self.adjust_period else 0)
            period = self.period - (self.warmup_epochs if self.adjust_period else 0)
        return self.min_lr + 0.5 * (self.max_lr - self.min_lr) * (
            1 + math.cos(math.pi * adjust / period))


def arguments_scheduler(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Scheduler arguments")
    group.add_argument("--scheduler.name", type=str, default="cosine")
    group.add_argument("--scheduler.is-iteration-based", action="store_true",
                       default=False)
    group.add_argument("--scheduler.max-epochs", type=int, default=350)
    group.add_argument("--scheduler.max-iterations", type=int, default=150000)
    group.add_argument("--scheduler.warmup-iterations", type=int, default=0)
    group.add_argument("--scheduler.warmup-init-lr", type=float, default=1e-7)
    group.add_argument("--scheduler.adjust-period-for-epochs", action="store_true",
                       help="Epoch-based cosine: shift the period past the warmup "
                            "epochs (reference semantics)")
    return SCHEDULER_REGISTRY.all_arguments(parser)


def build_scheduler(opts) -> BaseLRScheduler:
    name = (getattr(opts, "scheduler.name", "cosine") or "cosine").lower()
    if name not in SCHEDULER_REGISTRY:
        logger.error(f"Unsupported scheduler {name}; "
                     f"supported: {list(SCHEDULER_REGISTRY.keys())}")
    return SCHEDULER_REGISTRY[name](opts)
