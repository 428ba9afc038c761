"""Pooling (counterpart of cvnets_tpu/layers/pool.py)."""

from __future__ import annotations

import torch


def global_pool(x: torch.Tensor, pool_type: str = "mean") -> torch.Tensor:
    """Global mean over the spatial dims of an NCHW tensor -> (N, C). The JAX
    package's "rms" and "abs" pools are not ported yet."""
    if pool_type != "mean":
        raise ValueError(f"global pool `{pool_type}` is not ported; only `mean`")
    return x.mean(dim=(2, 3))
