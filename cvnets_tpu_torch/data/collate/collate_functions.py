"""Classification collate functions (counterpart of
cvnets_tpu/data/collate/collate_functions.py). A corrupt sample (target -1) is
replaced by a repeat of a valid one, so every batch keeps its size. The batch
is tensors: ``samples`` uint8 NCHW, ``targets`` and ``sample_id`` int64."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cvnets_tpu_torch.data.collate import COLLATE_FN_REGISTRY


def _stack_tree(batch: List):
    first = batch[0]
    if isinstance(first, dict):
        return {k: _stack_tree([b[k] for b in batch]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(batch)
    if isinstance(first, (bool, np.bool_)):
        return torch.tensor(batch, dtype=torch.bool)
    if isinstance(first, (int, np.integer)):
        return torch.tensor([int(b) for b in batch], dtype=torch.int64)
    if isinstance(first, (float, np.floating)):
        return torch.tensor([float(b) for b in batch], dtype=torch.float32)
    if isinstance(first, str):
        return list(batch)
    return torch.stack([torch.as_tensor(np.asarray(b)) for b in batch])


def _replace_corrupt(batch: List[Dict]) -> List[Dict]:
    """Corrupt samples (integer target -1) replaced by the valid ones in turn;
    a batch with no valid sample is left as it is."""
    def is_corrupt(item) -> bool:
        t = item.get("targets", None) if isinstance(item, dict) else None
        return isinstance(t, (int, np.integer)) and int(t) == -1

    valid = [b for b in batch if not is_corrupt(b)]
    if not valid or len(valid) == len(batch):
        return batch
    return valid + [valid[i % len(valid)] for i in range(len(batch) - len(valid))]


@COLLATE_FN_REGISTRY.register(name="default_collate_fn")
def default_collate_fn(batch: List[Dict], opts=None) -> Dict:
    return _stack_tree(_replace_corrupt(batch))


@COLLATE_FN_REGISTRY.register(name="image_classification_data_collate_fn")
def image_classification_data_collate_fn(batch: List[Dict], opts=None) -> Dict:
    return default_collate_fn(batch, opts)


@COLLATE_FN_REGISTRY.register(name="unlabeled_image_data_collate_fn")
def unlabeled_image_data_collate_fn(batch: List[Dict], opts=None) -> Dict:
    out = default_collate_fn(batch, opts)
    out.pop("targets", None)
    return out
