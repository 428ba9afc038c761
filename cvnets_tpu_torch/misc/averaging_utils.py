"""Exponential moving average of the full model state (counterpart of
cvnets_tpu/misc/averaging_utils.py and train_state.py:242-257): parameters AND
BatchNorm running statistics, ``ema = ema·(1 − m) + x·m``."""

from __future__ import annotations

import argparse
import copy

import torch
import torch.nn as nn


class EMA:
    """Holds ``model``, an averaged copy of the tracked model."""

    def __init__(self, model: nn.Module) -> None:
        self.model = copy.deepcopy(model).eval()
        self.model.requires_grad_(False)

    @staticmethod
    def _tracked(model: nn.Module):
        # float tensors only: BN's integer num_batches_tracked is not averaged
        return [t for t in model.state_dict().values() if t.is_floating_point()]

    @torch.no_grad()
    def update(self, model: nn.Module, momentum: float) -> None:
        torch._foreach_lerp_(self._tracked(self.model), self._tracked(model), momentum)


def arguments_ema(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="EMA")
    group.add_argument("--ema.enable", action="store_true")
    group.add_argument("--ema.momentum", type=float, default=0.0001)
    group.add_argument("--ema.copy-at-epoch", type=int, default=-1)
    return parser
