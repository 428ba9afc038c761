"""Train state and train step (counterpart of cvnets_tpu/engine/train_state.py:82-276).

The JAX step is one pure compiled program; this one runs eagerly and updates the
model, optimizer and EMA in place (no second copy of the state is made). Each step:
uint8 → [0, 1] on the device, autocast forward, backward of the loss (of its
``total_loss`` when the loss is a dict), global-norm clip
``min(1, clip / (norm + 1e-6))``, the optimizer at the scheduler's LR times each
param group's ``lr_mult``, EMA of params and BN statistics, ``step += 1``.

Not ported yet: grad accumulation, BN-momentum annealing, device augmentation,
mixup/cutmix and the metric objects.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.dtype_utils import autocast
from cvnets_tpu_torch.misc.averaging_utils import EMA


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[EMA] = None  # None when EMA is disabled
    step: int = 0


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       ema_enabled: bool = False) -> TrainState:
    """``model`` must already be on its device; the EMA copy lands beside it."""
    return TrainState(model=model, optimizer=optimizer,
                      ema=EMA(model) if ema_enabled else None)


def clip_grad_norm_(params: List[torch.Tensor], grad_clip: Optional[float]
                    ) -> torch.Tensor:
    """Scale the grads of ``params`` in place by ``min(1, clip / (norm + 1e-6))``
    (train_state.py:232-235) and return their pre-clip global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if grad_clip is not None and grad_clip > 0:
        torch._foreach_mul_(grads, torch.clamp(grad_clip / (norm + 1e-6), max=1.0))
    return norm


def make_train_step(model: nn.Module, criteria: Callable, opts
                    ) -> Callable[[TrainState, Dict, float], Tuple[TrainState, Dict]]:
    grad_clip = getattr(opts, "common.grad_clip", None)
    ema_momentum = getattr(opts, "ema.momentum", 0.0001)
    params = list(model.parameters())

    def train_step(state: TrainState, batch: Dict, lr: float
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        samples, targets = batch["samples"], batch["targets"]
        if samples.dtype == torch.uint8:
            samples = samples.float() / 255.0
        model.train()
        with autocast(opts, samples.device):
            prediction = model(samples)
            loss = criteria(samples, prediction, targets, training=True)
        total = loss["total_loss"] if isinstance(loss, dict) else loss
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        grad_norm = clip_grad_norm_(params, grad_clip)
        for group in state.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_mult", 1.0)
        state.optimizer.step()
        if state.ema is not None:
            state.ema.update(model, ema_momentum)
        state.step += 1
        metrics = {k: v.detach() for k, v in loss.items()} if isinstance(loss, dict) else {}
        metrics.update(loss=total.detach(), grad_norm=grad_norm.detach())
        return state, metrics

    return train_step
