"""Loader factory (counterpart of cvnets_tpu/data/data_loaders.py). ``device``
is where a training loader's native route decodes (``--dataset.decoder
native``), the card unless the caller asks for the CPU; ``pin_memory`` pins
the host batches for a copy to a card."""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from cvnets_tpu_torch.data.collate import build_collate_fn
from cvnets_tpu_torch.data.datasets import get_test_dataset, get_train_val_datasets
from cvnets_tpu_torch.data.loader.dataloader import CVNetsDataLoader
from cvnets_tpu_torch.data.sampler import build_sampler


def _n_workers(opts) -> int:
    n = getattr(opts, "dataset.workers", -1)
    return min(16, os.cpu_count() or 4) if n is None or n < 0 else n


def _loader(opts, dataset, sampler, mode: str, pin_memory: bool,
            device: Union[str, torch.device] = "cuda") -> CVNetsDataLoader:
    return CVNetsDataLoader(dataset=dataset, batch_sampler=sampler,
                            collate_fn=build_collate_fn(opts, mode),
                            num_workers=_n_workers(opts),
                            prefetch_factor=getattr(opts, "dataset.prefetch_factor", 2),
                            pin_memory=pin_memory, opts=opts, device=device)


def create_test_loader(opts, pin_memory: bool = False) -> CVNetsDataLoader:
    """The evaluation loader at ``--dataset.eval-batch-size0``; a variable-batch
    or multi-scale sampler becomes the batch sampler at its crop size."""
    test_dataset = get_test_dataset(opts)
    for k, v in (test_dataset.share_dataset_arguments() or {}).items():
        setattr(opts, k, v)
    eval_bsz = getattr(opts, "dataset.eval_batch_size0", None)
    if eval_bsz:
        setattr(opts, "dataset.val_batch_size0", eval_bsz)
    if getattr(opts, "sampler.name", "batch_sampler").startswith(
            ("variable_batch_sampler", "multi_scale_sampler")):
        setattr(opts, "sampler.name", "batch_sampler")
        setattr(opts, "sampler.bs.crop_size_height",
                getattr(opts, "sampler.vbs.crop_size_height", 256))
        setattr(opts, "sampler.bs.crop_size_width",
                getattr(opts, "sampler.vbs.crop_size_width", 256))
    sampler = build_sampler(opts, n_data_samples=len(test_dataset), is_training=False)
    return _loader(opts, test_dataset, sampler, "test", pin_memory)


def create_train_val_loader(opts, pin_memory: bool = False,
                            device: Union[str, torch.device] = "cuda"
                            ) -> Tuple[CVNetsDataLoader, Optional[CVNetsDataLoader], object]:
    """(train loader, val loader or None, train sampler)."""
    train_dataset, valid_dataset = get_train_val_datasets(opts)
    for k, v in (train_dataset.share_dataset_arguments() or {}).items():
        setattr(opts, k, v)
    train_sampler = build_sampler(opts, n_data_samples=len(train_dataset), is_training=True)
    train_loader = _loader(opts, train_dataset, train_sampler, "train", pin_memory, device)
    val_loader = None
    if valid_dataset is not None:
        val_sampler = build_sampler(opts, n_data_samples=len(valid_dataset), is_training=False)
        val_loader = _loader(opts, valid_dataset, val_sampler, "val", pin_memory)
    return train_loader, val_loader, train_sampler
