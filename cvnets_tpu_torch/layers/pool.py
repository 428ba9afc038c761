"""Pooling (counterpart of cvnets_tpu/layers/pool.py). The conv families use
the global pool only: ResNet's stem takes a strided depthwise conv where the
classic ResNet has a max pool."""

from __future__ import annotations

import torch

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
