"""Activations (counterpart of cvnets_tpu/layers/activation.py). Only the
default (relu), MobileViTv2's swish and ViT's gelu are ported. gelu is the exact
erf form, as the JAX package's ``partial(jax.nn.gelu, approximate=False)``
(activation.py:33), which is ``F.gelu``'s default."""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch.nn.functional as F

from cvnets_tpu_torch.utils import logger

SUPPORTED_ACT_FNS = {
    "relu": F.relu,
    "swish": F.silu,
    "gelu": F.gelu,
}


def build_act_layer(opts, act_name: Optional[str] = None) -> Callable:
    if act_name is None:
        act_name = getattr(opts, "model.activation.name", "relu") or "relu"
    act_name = act_name.lower()
    if act_name not in SUPPORTED_ACT_FNS:
        logger.error(
            f"Unsupported activation `{act_name}`. Supported: {sorted(SUPPORTED_ACT_FNS)}")
    return SUPPORTED_ACT_FNS[act_name]


def arguments_activation_fn(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Non-linearity arguments")
    group.add_argument("--model.activation.name", type=str, default="relu")
    return parser
