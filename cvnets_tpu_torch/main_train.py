"""Training entry point of the port (counterpart of main_train.py):

    python -m cvnets_tpu_torch.main_train --common.config-file <yaml> [flags]

builds the train and val loaders (pinned batches on a CUDA device), the model,
the loss and the ``Trainer``, and runs it on ``device``, the CUDA card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import random
import sys
from typing import List, Optional, Union

import numpy as np
import torch

from cvnets_tpu_torch.data.data_loaders import create_train_val_loader
from cvnets_tpu_torch.engine import Trainer
from cvnets_tpu_torch.loss import build_loss_fn
from cvnets_tpu_torch.models import get_model
from cvnets_tpu_torch.options.opts import get_training_arguments
from cvnets_tpu_torch.utils import logger


def device_setup(opts, device: Union[str, torch.device, None]) -> torch.device:
    """Seed Python's, numpy's and torch's generators with ``common.seed`` and
    return the device, which must exist."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    seed = getattr(opts, "common.seed", 0) or 0
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return device


def main(opts, device: Union[str, torch.device, None] = None, **kwargs) -> Trainer:
    if getattr(opts, "common.int8_inference", False):
        logger.error(
            "--common.int8-inference is an inference-only flag (rounding has "
            "zero gradient); unset it for training and pass it to main_eval/"
            "main_benchmark instead.")
    device = device_setup(opts, device)
    train_loader, val_loader, train_sampler = create_train_val_loader(
        opts, pin_memory=device.type == "cuda", device=device)
    model = get_model(opts, device=device)
    trainer = Trainer(opts, model, build_loss_fn(opts, device=device), train_loader, val_loader,
                      device=device, train_sampler=train_sampler)
    trainer.run()
    return trainer


def main_worker(args: Optional[List[str]] = None,
                device: Union[str, torch.device, None] = None, **kwargs) -> Trainer:
    return main(get_training_arguments(args=args), device=device, **kwargs)


if __name__ == "__main__":
    main_worker(sys.argv[1:])
