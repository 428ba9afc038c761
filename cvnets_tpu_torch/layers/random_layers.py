"""Stochastic layers (counterpart of cvnets_tpu/layers/random_layers.py:13-30).

``StochasticDepth`` in row mode (torchvision's drop-path): in training, each
batch row survives with probability ``keep = 1 - p`` and survivors are scaled by
``1 / keep``; in eval, or at ``p = 0``, it is the identity. The draws come from
``generator`` when one is given (the JAX layer draws from flax's ``dropout``
stream, so the two packages never draw the same rows). ``RandomApply`` is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class StochasticDepth(nn.Module):
    def __init__(self, p: float = 0.0, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        draw = torch.rand(shape, generator=self.generator,
                          device=self.generator.device if self.generator else x.device)
        mask = (draw.to(x.device) < keep).to(x.dtype)
        return x * mask / keep

    def extra_repr(self) -> str:
        return f"p={self.p}"
