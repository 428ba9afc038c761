"""RangeAugment's neural augmentor (counterpart of
cvnets_tpu/models/neural_augmentor/neural_aug.py; arXiv:2212.10553).

Learnable magnitudes of brightness, contrast and noise, applied inside the
model's training forward to [0, 1] images (NCHW float32). ``basic`` mode
learns one scalar ``{name}_mag`` an augmentation; ``distribution`` mode learns
the range ``{name}_min`` / ``{name}_max`` of a uniform magnitude drawn each
call. Parameters exist for the enabled augmentations only, in the order
brightness, contrast, noise. Each in turn draws its magnitude, applies
``y·m``, ``(y − mean)·m + mean`` (the mean over C, H, W of each image) or
``y + N(0, 1)·m``, clips to [0, 1] by a straight-through clip (the clipped
value forward, the identity's gradient backward) and keeps the result on a
Bernoulli(0.5) half of the batch. Outside training it passes its input
through.

The draws (each augmentation's uniform, its row selection and the noise) are
one argument of ``forward``; ``draw(x, generator)`` makes them on ``x``'s
device, with no host sync. The train step draws them from a generator
seeded by (seed, step, stream), so a resumed run draws what an unbroken one
does; a test can pass the JAX package's draws instead. The training forward
runs inside a ``torch.profiler`` range named ``AUGMENTOR_RANGE``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
from torch.profiler import record_function

from cvnets_tpu_torch.utils import logger

AUGMENTATIONS = ("brightness", "contrast", "noise")
# (basic magnitude, distribution (min, max)) inits (neural_aug.py:42-51)
_INIT = {"brightness": (1.0, (0.5, 1.5)), "contrast": (1.0, (0.5, 1.5)),
         "noise": (0.0, (0.0, 0.1))}

Draws = Dict[str, Dict[str, Optional[torch.Tensor]]]
AUGMENTOR_RANGE = "neural_augmentor"


def straight_through_clip(x: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return x + (torch.clamp(x, lo, hi) - x).detach()


class NeuralAugmentor(nn.Module):
    def __init__(self, opts, mode: str = "distribution") -> None:
        super().__init__()
        if mode not in ("basic", "distribution"):
            logger.error(f"Unsupported neural augmentor mode {mode}; supported: "
                         "['basic', 'distribution']")
        self.mode = mode
        self.enabled: List[str] = [name for name in AUGMENTATIONS if getattr(
            opts, f"model.learn_augmentation.{name}", False)]
        for name in self.enabled:
            mag, (lo, hi) = _INIT[name]
            if mode == "basic":
                setattr(self, f"{name}_mag", nn.Parameter(torch.tensor(mag)))
            else:
                setattr(self, f"{name}_min", nn.Parameter(torch.tensor(lo)))
                setattr(self, f"{name}_max", nn.Parameter(torch.tensor(hi)))

    def draw(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Draws:
        """One call's draws for a batch like ``x``, on its device, from
        ``generator`` (the device's default one when None)."""
        n = x.shape[0]
        draws: Draws = {}
        for name in self.enabled:
            draws[name] = {
                "u": (torch.rand((), generator=generator, device=x.device)
                      if self.mode == "distribution" else None),
                "select": torch.rand(n, generator=generator, device=x.device) < 0.5,
                "noise": (torch.randn(x.shape, generator=generator, device=x.device,
                                      dtype=x.dtype) if name == "noise" else None)}
        return draws

    def magnitude(self, name: str, u: Optional[torch.Tensor]) -> torch.Tensor:
        if self.mode == "basic":
            return getattr(self, f"{name}_mag")
        lo, hi = getattr(self, f"{name}_min"), getattr(self, f"{name}_max")
        return lo + u * (hi - lo)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None) -> torch.Tensor:
        if not self.training or not self.enabled:
            return x
        with record_function(AUGMENTOR_RANGE):
            return self._augment(x, self.draw(x) if draws is None else draws)

    def _augment(self, x: torch.Tensor, draws: Draws) -> torch.Tensor:
        y = x
        for name in self.enabled:
            d = draws[name]
            mag = self.magnitude(name, d["u"])
            if name == "brightness":
                aug = y * mag
            elif name == "contrast":
                mean = y.mean(dim=(1, 2, 3), keepdim=True)
                aug = (y - mean) * mag + mean
            else:
                aug = y + d["noise"] * mag
            select = d["select"].view((-1,) + (1,) * (y.dim() - 1))
            y = torch.where(select, straight_through_clip(aug), y)
        return y


def build_neural_augmentor(opts) -> Optional[NeuralAugmentor]:
    mode = getattr(opts, "model.learn_augmentation.mode", None)
    if mode is None:
        return None
    mult = getattr(opts, "model.learn_augmentation.lr_multiplier", 1.0)
    if mult is not None and mult != 1.0:
        logger.warning(f"--model.learn-augmentation.lr-multiplier {mult} is parsed and not "
                       "applied, as in the JAX package: the augmentor's magnitudes take the "
                       "scheduler's LR")
    return NeuralAugmentor(opts, mode=mode)
