"""Seeds, the device and the run's directories (counterpart of
cvnets_tpu/utils/common_utils.py:14-54)."""

from __future__ import annotations

import os
import random
from typing import Union

import numpy as np
import torch

from cvnets_tpu_torch import parallel


def device_setup(opts, device: Union[str, torch.device, None] = None) -> torch.device:
    """Seed Python's, numpy's and torch's generators and return the device,
    which must exist: ``device``, else the card (``cuda:{local rank}`` in a
    process group, ``cuda`` without one).

    Python's and numpy's generators take ``common.seed`` on every rank (the
    samplers' draws are the same on each); torch's default generators, which
    dropout and stochastic depth draw from, take it at data index 0 and
    (``common.seed``, data index) at the others, so data ranks drop different
    units where JAX draws one mask over the global batch, and the ranks of a
    model group, which hold the same rows, drop the same ones (tensor
    parallelism sums partial products of one mask). A model's weights come
    from a generator of their own seeded with ``common.seed``
    (``models.get_model``), the same on every rank."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if parallel.is_initialized() and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    seed = getattr(opts, "common.seed", 0) or 0
    random.seed(seed)
    np.random.seed(seed)
    index = parallel.data_index()
    torch.manual_seed(seed if index == 0 else
                      int(np.random.SeedSequence([seed, index]).generate_state(1)[0]))
    return device


def create_directories(dir_path: str, is_master_node: bool) -> None:
    """``dir_path`` made by the master; the other ranks wait for it."""
    if is_master_node and not os.path.isdir(dir_path):
        os.makedirs(dir_path, exist_ok=True)
    parallel.barrier()
