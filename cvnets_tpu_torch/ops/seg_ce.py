"""Fused bilinear-upsample + pixel cross-entropy for segmentation training
(counterpart of cvnets_tpu/ops/seg_ce.py).

The loss of ``bilinear_resize(logits, labels' size)`` against the labels is
computed without the (B, H, W, C) full-resolution logits, through the autograd
Function of ``ops/seg_ce_kernel.py``: its CUDA kernels on a CUDA tensor, their
plain versions on a CPU tensor. Bilinear resize is separable and linear, so it
is two (out, in) matrices ``A_h`` and ``A_w`` built with ``jax.image.resize``'s
weights (half-pixel centres, a triangle filter widened when downsampling).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from cvnets_tpu_torch.ops.seg_ce_kernel import (
    InterpTaps,
    ResizeCE,
    interp_taps,
    pixel_ce,
    resize_matrix_weights,
    upload,
)


@functools.lru_cache(maxsize=32)
def resize_matrix(out_size: int, in_size: int,
                  device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """``resize_matrix_weights`` on ``device``, built once per (shape, device);
    callers share the tensor and must not modify it."""
    return upload(resize_matrix_weights(out_size, in_size), device)


@functools.lru_cache(maxsize=32)
def resize_taps(out_size: int, in_size: int, device: torch.device) -> InterpTaps:
    """The kernels' tables of ``resize_matrix(out, in)`` on ``device``, built
    once per (shape, device); callers must not modify them."""
    return interp_taps(resize_matrix_weights(out_size, in_size)).to(device)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, h, w) → (B, C, H, W) with ``jax.image.resize(..., 'bilinear')``'s
    weights (the eval-time upsampling of enc_dec.py:61-68)."""
    ah = resize_matrix(size[0], x.shape[-2], x.device).to(x.dtype)
    aw = resize_matrix(size[1], x.shape[-1], x.device).to(x.dtype)
    return torch.einsum("Hh,bchw,Ww->bcHW", ah, x, aw)


def fused_resize_ce_sum(logits: torch.Tensor, target: torch.Tensor, *, ignore_idx: int = 255,
                        label_smoothing: float = 0.0,
                        class_wts: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pixel CE of ``bilinear_resize(logits, target's (H, W))`` against
    ``target`` (seg_ce.py:55) as (weighted loss sum, unweighted count of valid
    pixels), the pair the kernels produce: logits (B, h, w, C) (the JAX
    package's NHWC; a permuted view of NCHW logits is fine), target (B, H, W)
    int with ``ignore_idx`` holes, ``class_wts`` (C,) or None. On a CUDA
    tensor this runs the kernels or raises; on a CPU tensor, their plain
    versions."""
    b, h, w, c = logits.shape
    big_h, big_w = int(target.shape[1]), int(target.shape[2])
    ah = resize_matrix(big_h, h, logits.device)
    aw = resize_matrix(big_w, w, logits.device)
    ah_taps = aw_taps = None
    if logits.device.type != "cpu":
        ah_taps = resize_taps(big_h, h, logits.device)
        aw_taps = resize_taps(big_w, w, logits.device)
    if class_wts is not None:
        class_wts = class_wts.float()
    return ResizeCE.apply(logits, target, ah, aw, ah_taps, aw_taps, class_wts, ignore_idx,
                          float(label_smoothing))


def resize_ce_plain_sum(logits: torch.Tensor, target: torch.Tensor, *, ignore_idx: int = 255,
                        label_smoothing: float = 0.0,
                        class_wts: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same pair unfused: the full-resolution logits are built and the CE
    runs over them, differentiable by autograd (the reference's upsample-then-CE
    path; the plain side of the kernel/plain A/B)."""
    b, h, w, c = logits.shape
    ah = resize_matrix(int(target.shape[1]), h, logits.device)
    aw = resize_matrix(int(target.shape[2]), w, logits.device)
    with torch.autocast(logits.device.type, enabled=False):
        up = torch.einsum("Hh,bhwc,Ww->bHWc", ah, logits.float(), aw)
        loss, valid = pixel_ce(up, target, class_wts, ignore_idx, float(label_smoothing))
        return loss.sum(), valid.sum(dtype=torch.float32)


def fused_resize_ce(logits: torch.Tensor, target: torch.Tensor, **kwargs) -> torch.Tensor:
    """Mean pixel CE through the kernels (``fused_resize_ce_sum``'s keywords):
    the weighted sum over the *unweighted* count of valid pixels."""
    loss_sum, n_valid = fused_resize_ce_sum(logits, target, **kwargs)
    return loss_sum / n_valid.clamp(min=1.0)


def resize_ce_plain(logits: torch.Tensor, target: torch.Tensor, **kwargs) -> torch.Tensor:
    """The same mean unfused (``resize_ce_plain_sum``)."""
    loss_sum, n_valid = resize_ce_plain_sum(logits, target, **kwargs)
    return loss_sum / n_valid.clamp(min=1.0)
