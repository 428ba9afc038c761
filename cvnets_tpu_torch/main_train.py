"""Training entry point of the port (counterpart of main_train.py):

    python -m cvnets_tpu_torch.main_train --common.config-file <yaml> [flags]

builds the train and val loaders (pinned batches on a CUDA device), the model,
the loss and the ``Trainer``, and runs it on ``device``, the CUDA card unless
the caller asks for the CPU.

Over several cards it runs one process a card (``parallel.launch``):
``--dev.num-devices N`` spawns N processes, and
under ``torchrun --nproc-per-node N -m cvnets_tpu_torch.main_train ...`` the
launcher's ranks are used. Each process draws the yaml's per-card batch, so
the global batch is the recipe's. A rank that fails ends the run with a
nonzero exit.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Union

import torch

from cvnets_tpu_torch.data.data_loaders import create_train_val_loader
from cvnets_tpu_torch.engine import Trainer
from cvnets_tpu_torch.loss import build_loss_fn
from cvnets_tpu_torch.models import get_model
from cvnets_tpu_torch.options.opts import get_training_arguments
from cvnets_tpu_torch.parallel import launch
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.common_utils import device_setup


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
                device: Union[str, torch.device, None] = None, **kwargs) -> Optional[Trainer]:
    """The Trainer after its run, or None where the run took spawned processes."""
    return launch(main, get_training_arguments(args=args), device)


if __name__ == "__main__":
    main_worker(sys.argv[1:])
