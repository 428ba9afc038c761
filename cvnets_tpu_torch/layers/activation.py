"""Activations (counterpart of cvnets_tpu/layers/activation.py). Only the
default (relu) and MobileViTv2's swish are ported."""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch.nn.functional as F

from cvnets_tpu.utils import logger

SUPPORTED_ACT_FNS = {
    "relu": F.relu,
    "swish": F.silu,
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
