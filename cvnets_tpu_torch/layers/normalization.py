"""Normalization layers (counterpart of cvnets_tpu/layers/normalization.py).

* ``batch_norm`` is ``nn.BatchNorm2d`` with the yaml's momentum used as it is: the
  configs carry the torch convention, and torch already tracks the Bessel-corrected
  running variance that the JAX package's ``TorchBatchNorm`` imitates.
* ``layer_norm_2d`` is GroupNorm with ONE group (normalization.py:190-193):
  statistics over channels and space jointly, affine per channel. It is applied to
  channels-last tensors, the layout of MobileViTv2's (B, P, N, C) patches.
* ``layer_norm`` is ``nn.LayerNorm`` over the trailing axis only, with the
  caller's eps (normalization.py:185-188); ViT's (B, S, E) tokens take it.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.utils import logger

BATCH_NORMS = ("batch_norm", "batch_norm_2d", "sync_batch_norm")
SUPPORTED_NORM_FNS = BATCH_NORMS + ("layer_norm", "layer_norm_2d", "identity")


class LayerNorm2d(nn.Module):
    """GroupNorm(num_groups=1) for a channels-last tensor (B, ..., C): one mean
    and variance over every non-batch element, then a per-channel affine."""

    def __init__(self, num_features: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[1:], eps=self.eps) * self.weight + self.bias


def get_normalization_layer(opts, num_features: int,
                            norm_type: Optional[str] = None,
                            eps: float = 1e-5) -> Optional[nn.Module]:
    if norm_type is None:
        norm_type = getattr(opts, "model.normalization.name", "batch_norm")
    norm_type = (norm_type or "batch_norm").lower()
    momentum = getattr(opts, "model.normalization.momentum", 0.1)
    if norm_type in BATCH_NORMS:
        # on one device sync-BN is plain BN, as under GSPMD in the JAX package
        return nn.BatchNorm2d(num_features, eps=eps,
                              momentum=0.1 if momentum is None else momentum)
    if norm_type == "layer_norm":
        return nn.LayerNorm(num_features, eps=eps)
    if norm_type == "layer_norm_2d":
        return LayerNorm2d(num_features, eps=eps)
    if norm_type == "identity":
        return None
    logger.error(f"Unsupported norm layer `{norm_type}`. Supported: {SUPPORTED_NORM_FNS}")


def arguments_norm_layers(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Normalization layer arguments")
    group.add_argument("--model.normalization.name", type=str, default="batch_norm")
    group.add_argument(
        "--model.normalization.momentum", type=float, default=0.1,
        help="BN momentum in the torch convention (fraction of new batch statistic)",
    )
    return parser
