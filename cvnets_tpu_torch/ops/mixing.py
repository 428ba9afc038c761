"""Batch-level mixup and cutmix with soft targets, on the device (counterpart of
cvnets_tpu/ops/mixing.py). Their random parameters (the choice between them,
whether to apply, λ, the box's centre) are drawn on the host from a
``np.random.Generator``; the arithmetic that depends on them is the JAX op's, in
float32."""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def one_hot(targets: torch.Tensor, n_classes: int) -> torch.Tensor:
    """float32 one-hot rows (a row of zeros for a label outside [0, n_classes),
    as ``jax.nn.one_hot``); soft targets pass through."""
    if targets.dim() == 2:
        return targets
    classes = torch.arange(n_classes, device=targets.device)
    return (targets.unsqueeze(-1) == classes).to(torch.float32)


def mixup(samples: torch.Tensor, soft: torch.Tensor, lam: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend with the batch rolled by one: ``x·λ + roll(x)·(1 − λ)``, the
    targets likewise (``lam`` a float32 value)."""
    lam = float(np.float32(lam))
    rest = float(np.float32(1.0) - np.float32(lam))
    mixed_x = samples * lam + torch.roll(samples, 1, dims=0) * rest
    return mixed_x.to(samples.dtype), soft * lam + torch.roll(soft, 1, dims=0) * rest


def cutmix_box(h: int, w: int, lam: float, cy: int, cx: int) -> Tuple[int, int, int, int, float]:
    """(y0, y1, x0, x1, λ adjusted to the box's area) of a box of sides
    ``side·sqrt(1 − λ)`` centred on (cy, cx) and cut at the edges, in float32 as
    the JAX op."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h, cut_w = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
    y0, y1 = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
    x0, x1 = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
    lam_adj = np.float32(1.0) - np.float32((y1 - y0) * (x1 - x0)) / np.float32(h * w)
    return int(y0), int(y1), int(x0), int(x1), float(lam_adj)


def cutmix(samples: torch.Tensor, soft: torch.Tensor, lam: float, cy: int, cx: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The box of ``cutmix_box`` (NCHW) taken from the batch rolled by one; the
    targets mixed at the box's share."""
    h, w = samples.shape[-2:]
    y0, y1, x0, x1, lam_adj = cutmix_box(h, w, lam, cy, cx)
    mixed_x = samples.clone()
    mixed_x[..., y0:y1, x0:x1] = torch.roll(samples, 1, dims=0)[..., y0:y1, x0:x1]
    rest = float(np.float32(1.0) - np.float32(lam_adj))
    return mixed_x, soft * lam_adj + torch.roll(soft, 1, dims=0) * rest


def build_mixing_fn(opts) -> Optional[Callable]:
    """``fn(samples, targets, n_classes, rng) -> (samples, soft targets)``: a random
    choice between the enabled mixup and cutmix for the batch, applied with
    probability p (mixup's when it is enabled, else cutmix's, as in the JAX
    package); None when neither is enabled."""
    mixup_enabled = getattr(opts, "image_augmentation.mixup.enable", False)
    cutmix_enabled = getattr(opts, "image_augmentation.cutmix.enable", False)
    if not (mixup_enabled or cutmix_enabled):
        return None
    mixup_alpha = getattr(opts, "image_augmentation.mixup.alpha", 0.2)
    cutmix_alpha = getattr(opts, "image_augmentation.cutmix.alpha", 1.0)
    p = (getattr(opts, "image_augmentation.mixup.p", 1.0) if mixup_enabled
         else getattr(opts, "image_augmentation.cutmix.p", 1.0))
    branches = (["mixup"] if mixup_enabled else []) + (["cutmix"] if cutmix_enabled else [])

    def mixing_fn(samples: torch.Tensor, targets: torch.Tensor, n_classes: int,
                  rng: np.random.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        soft = one_hot(targets, n_classes)
        branch = branches[int(rng.integers(0, len(branches)))]
        if rng.random() >= p:
            return samples, soft
        h, w = samples.shape[-2:]
        if branch == "mixup":
            return mixup(samples, soft, np.float32(rng.beta(mixup_alpha, mixup_alpha)))
        lam = np.float32(rng.beta(cutmix_alpha, cutmix_alpha))
        return cutmix(samples, soft, lam, int(rng.integers(0, h)), int(rng.integers(0, w)))

    return mixing_fn


def arguments_mixing(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Mixup/Cutmix arguments")
    group.add_argument("--image-augmentation.mixup.enable", action="store_true",
                       default=False)
    group.add_argument("--image-augmentation.mixup.alpha", type=float, default=0.2)
    group.add_argument("--image-augmentation.mixup.p", type=float, default=1.0)
    group.add_argument("--image-augmentation.cutmix.enable", action="store_true",
                       default=False)
    group.add_argument("--image-augmentation.cutmix.alpha", type=float, default=1.0)
    group.add_argument("--image-augmentation.cutmix.p", type=float, default=1.0)
    return parser
