"""Pooling (counterpart of cvnets_tpu/layers/pool.py): the global pool of the
classifiers, ``MaxPool2d`` and ``AvgPool2d``, and the adaptive average pool of
PSPNet's pyramid. NCHW. The conv families use the global pool only: ResNet's
stem takes a strided depthwise conv where the classic ResNet has a max pool."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

GLOBAL_POOLS = ("mean", "rms", "abs")


def global_pool(x: torch.Tensor, pool_type: str = "mean") -> torch.Tensor:
    """Global pool over the spatial dims of an NCHW tensor -> (N, C): the mean,
    the root of the mean square ("rms") or the mean magnitude ("abs"), as
    ``GlobalPool`` (pool.py:11-36)."""
    if pool_type == "rms":
        return x.pow(2).mean(dim=(2, 3)).sqrt()
    if pool_type == "abs":
        return x.abs().mean(dim=(2, 3))
    if pool_type != "mean":
        raise ValueError(f"global pool `{pool_type}` is not one of {GLOBAL_POOLS}")
    return x.mean(dim=(2, 3))


class MaxPool2d(nn.Module):
    """flax ``max_pool`` with symmetric padding (pool.py:39-51): padded
    positions never win."""

    def __init__(self, kernel_size: int = 3, stride: int = 2, padding: int = 1) -> None:
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2d(nn.Module):
    """flax ``avg_pool`` with symmetric padding (pool.py:54-66): the padded
    zeros count in the mean."""

    def __init__(self, kernel_size: int = 2, stride: int = 2, padding: int = 0) -> None:
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            count_include_pad=True)


def adaptive_avg_pool_2d(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """The JAX package's adaptive average pool (pool.py:69-84): windows of
    ceil(H / oh) × ceil(W / ow) at strides floor(H / oh), floor(W / ow), no
    padding, the first oh × ow kept. It is not ``F.adaptive_avg_pool2d``,
    whose windows differ where oh does not divide H: at 32 → 3 the rows are
    [0, 11), [10, 21), [20, 31) here and [0, 11), [10, 22), [21, 32) there."""
    h, w = x.shape[-2:]
    oh, ow = output_size
    kernel = (-(-h // oh), -(-w // ow))
    stride = (max(1, h // oh), max(1, w // ow))
    return F.avg_pool2d(x, kernel, stride)[..., :oh, :ow]
