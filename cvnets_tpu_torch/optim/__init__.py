"""Optimizer construction on torch.optim (counterpart of
cvnets_tpu/optim/__init__.py). SGD and AdamW are ported.

``optim.no_decay_bn_filter_bias`` decays only tensors of rank > 1 (the JAX
``_decay_mask``, optim/__init__.py:41): biases and norm affines are rank 1.
``lr_multipliers`` (a model's ``get_lr_multipliers``: regex → multiplier) scale
the update of every parameter whose name matches, as the JAX masked
``optax.scale`` does (optim/__init__.py:247-278); the regex is searched in the
parameter's name with ``/`` for ``.``, the flax path's separator. There is one
param group per (decay, multiplier) pair; each carries its ``lr_mult``, and the
train step writes ``lr · lr_mult`` into it every iteration, as the JAX step
writes the LR into ``inject_hyperparams`` state.

torch's SGD and optax's ``add_decayed_weights`` → ``sgd`` agree: the coupled
decay ``g + wd·p`` enters the momentum buffer, which starts at ``g`` on the
first step in both. torch's AdamW and optax's adamw agree too:
p ← p − lr·(m̂/(√v̂ + eps) + wd·p), the decay term only where the mask allows.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.registry import Registry

OPTIM_REGISTRY = Registry(registry_name="torch_optimizer")


def arguments_optimizer(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Optimizer arguments")
    group.add_argument("--optim.name", type=str, default="sgd")
    group.add_argument("--optim.eps", type=float, default=1e-8)
    group.add_argument("--optim.weight-decay", type=float, default=4e-5)
    group.add_argument("--optim.no-decay-bn-filter-bias", action="store_true",
                       default=False)
    return OPTIM_REGISTRY.all_arguments(parser)


def param_groups(model: nn.Module, weight_decay: float, no_decay_bn_filter_bias: bool,
                 lr_multipliers: Optional[Dict[str, float]] = None) -> List[dict]:
    patterns = [(re.compile(p), m) for p, m in (lr_multipliers or {}).items() if m != 1.0]
    groups: Dict[tuple, dict] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        decay = weight_decay if (p.dim() > 1 or not no_decay_bn_filter_bias) else 0.0
        mult = 1.0
        for rx, m in patterns:
            if rx.search(name.replace(".", "/")):
                mult *= m
        group = groups.setdefault((decay, mult), {"params": [], "weight_decay": decay,
                                                  "lr_mult": mult})
        group["params"].append(p)
    return list(groups.values())


@OPTIM_REGISTRY.register("sgd")
class SGDOptimizer:
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title="SGD arguments")
        group.add_argument("--optim.sgd.momentum", type=float, default=0.9)
        group.add_argument("--optim.sgd.nesterov", action="store_true", default=False)
        return parser

    @staticmethod
    def make(opts, groups: List[dict]) -> torch.optim.Optimizer:
        # lr is set by the train step before every update
        return torch.optim.SGD(groups, lr=0.0,
                               momentum=getattr(opts, "optim.sgd.momentum", 0.9),
                               nesterov=getattr(opts, "optim.sgd.nesterov", False))


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


def build_optimizer(opts, model: nn.Module,
                    lr_multipliers: Optional[Dict[str, float]] = None
                    ) -> torch.optim.Optimizer:
    optim_name = (getattr(opts, "optim.name", "sgd") or "sgd").lower()
    if optim_name not in OPTIM_REGISTRY:
        logger.error(f"Unsupported optimizer {optim_name}; "
                     f"supported: {list(OPTIM_REGISTRY.keys())}")
    groups = param_groups(model, getattr(opts, "optim.weight_decay", 0.0) or 0.0,
                          getattr(opts, "optim.no_decay_bn_filter_bias", False),
                          lr_multipliers)
    return OPTIM_REGISTRY[optim_name].make(opts, groups)
