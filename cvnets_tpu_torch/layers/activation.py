"""Activations (counterpart of cvnets_tpu/layers/activation.py): the whole
registry. gelu is the exact erf form, as the JAX package's
``partial(jax.nn.gelu, approximate=False)`` (activation.py:33), which is
``F.gelu``'s default. ``hard_sigmoid`` and ``hard_swish`` are the JAX
package's ``relu6(x + 3) / 6`` and ``x * relu6(x + 3) / 6`` (:19-25), which
``F.hardsigmoid`` and ``F.hardswish`` compute in one kernel each (held to the
JAX forms on the CPU by tests/test_torch_conv_layers.py). ``prelu`` is a module
with the JAX ``alpha`` leaf; ``none``, ``identity`` and ``linear`` return
their input.
"""

from __future__ import annotations

import argparse
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.utils import logger


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


SUPPORTED_ACT_FNS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": partial(F.leaky_relu, negative_slope=0.1),
    "swish": F.silu,
    "silu": F.silu,
    "gelu": F.gelu,
    "hard_swish": F.hardswish,
    "hard_sigmoid": F.hardsigmoid,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "prelu": None,  # parametric: PReLU below
}
IDENTITY_NAMES = ("none", "identity", "linear")


class PReLU(nn.Module):
    """``x`` where ``x >= 0``, else ``alpha * x``; ``alpha`` has one entry, or
    one per channel of an NCHW tensor (the JAX module's last axis)."""

    def __init__(self, num_parameters: int = 1, init_value: float = 0.25) -> None:
        super().__init__()
        self.alpha = nn.Parameter(torch.full((num_parameters,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha
        if alpha.numel() > 1 and x.dim() > 2:
            alpha = alpha.view(-1, *(1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, alpha * x)


def build_act_layer(opts, act_name: Optional[str] = None,
                    prefix: str = "model.activation") -> Callable:
    """The activation that ``act_name`` names, else ``<prefix>.name``."""
    if act_name is None:
        act_name = getattr(opts, f"{prefix}.name", "relu") or "relu"
    act_name = act_name.lower()
    if act_name == "prelu":
        return PReLU()
    if act_name in IDENTITY_NAMES:
        return identity
    if act_name == "leaky_relu":
        return partial(F.leaky_relu,
                       negative_slope=getattr(opts, f"{prefix}.neg_slope", 0.1))
    if act_name not in SUPPORTED_ACT_FNS:
        logger.error(
            f"Unsupported activation `{act_name}`. Supported: {sorted(SUPPORTED_ACT_FNS)}")
    return SUPPORTED_ACT_FNS[act_name]


def arguments_activation_fn(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Non-linearity arguments")
    group.add_argument("--model.activation.name", type=str, default="relu")
    group.add_argument("--model.activation.inplace", action="store_true",
                       help="Kept for the yamls; the port's activations are not in place")
    group.add_argument("--model.activation.neg-slope", type=float, default=0.1)
    return parser
