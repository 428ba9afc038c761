"""Optimizer construction on torch.optim (counterpart of
cvnets_tpu/optim/__init__.py). Only AdamW is ported.

``optim.no_decay_bn_filter_bias`` decays only tensors of rank > 1 (the JAX
``_decay_mask``, optim/__init__.py:41): biases and norm affines are rank 1. The
train step writes the scheduler's LR into every param group each iteration, as the
JAX step writes it into ``inject_hyperparams`` state.

torch's AdamW and optax's adamw agree: both apply
p ← p − lr·(m̂/(√v̂ + eps) + wd·p), the decay term only where the mask allows.
"""

from __future__ import annotations

import argparse
from typing import List

import torch
import torch.nn as nn

from cvnets_tpu.utils import logger
from cvnets_tpu.utils.registry import Registry

OPTIM_REGISTRY = Registry(registry_name="torch_optimizer")


def arguments_optimizer(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Optimizer arguments")
    group.add_argument("--optim.name", type=str, default="sgd")
    group.add_argument("--optim.eps", type=float, default=1e-8)
    group.add_argument("--optim.weight-decay", type=float, default=4e-5)
    group.add_argument("--optim.no-decay-bn-filter-bias", action="store_true",
                       default=False)
    return OPTIM_REGISTRY.all_arguments(parser)


def param_groups(model: nn.Module, weight_decay: float, no_decay_bn_filter_bias: bool
                 ) -> List[dict]:
    params = [p for p in model.parameters() if p.requires_grad]
    if not no_decay_bn_filter_bias:
        return [{"params": params, "weight_decay": weight_decay}]
    return [{"params": [p for p in params if p.dim() > 1], "weight_decay": weight_decay},
            {"params": [p for p in params if p.dim() <= 1], "weight_decay": 0.0}]


@OPTIM_REGISTRY.register("adamw")
class AdamWOptimizer:
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title="AdamW arguments")
        group.add_argument("--optim.adamw.beta1", type=float, default=0.9)
        group.add_argument("--optim.adamw.beta2", type=float, default=0.999)
        group.add_argument("--optim.adamw.eps", type=float, default=None,
                           help="Overrides --optim.eps for AdamW when set")
        return parser

    @staticmethod
    def make(opts, groups: List[dict]) -> torch.optim.Optimizer:
        betas = (getattr(opts, "optim.adamw.beta1", 0.9),
                 getattr(opts, "optim.adamw.beta2", 0.999))
        eps = getattr(opts, "optim.adamw.eps", None) or getattr(opts, "optim.eps", 1e-8)
        # lr is set by the train step before every update
        return torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=eps)


def build_optimizer(opts, model: nn.Module) -> torch.optim.Optimizer:
    optim_name = (getattr(opts, "optim.name", "sgd") or "sgd").lower()
    if optim_name not in OPTIM_REGISTRY:
        logger.error(f"Unsupported optimizer {optim_name}; "
                     f"supported: {list(OPTIM_REGISTRY.keys())}")
    groups = param_groups(model, getattr(opts, "optim.weight_decay", 0.0) or 0.0,
                          getattr(opts, "optim.no_decay_bn_filter_bias", False))
    return OPTIM_REGISTRY[optim_name].make(opts, groups)
