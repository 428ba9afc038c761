"""Mixed-precision policy (counterpart of cvnets_tpu/layers/dtype_utils.py).

The JAX package threads a compute dtype through every layer; here the same policy
is ``torch.autocast``: convs and matmuls run in the autocast dtype (bfloat16 by
default), while parameters and optimizer state stay float32. As on the TPU there is
no loss scaling.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float": torch.float32,
}


def compute_dtype(opts) -> torch.dtype:
    if opts is None or not getattr(opts, "common.mixed_precision", False):
        return torch.float32
    name = getattr(opts, "common.mixed_precision_dtype", "bfloat16") or "bfloat16"
    return _DTYPES.get(name, torch.bfloat16)


def autocast(opts, device: torch.device) -> torch.autocast:
    """Autocast context for the forward pass; disabled when the compute dtype is
    float32."""
    dt = compute_dtype(opts)
    return torch.autocast(device_type=device.type, dtype=dt,
                          enabled=dt != torch.float32)
