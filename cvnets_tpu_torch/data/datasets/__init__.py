"""Dataset registry (counterpart of cvnets_tpu/data/datasets/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.data.datasets.dataset_base import BaseDataset
from cvnets_tpu_torch.utils.registry import Registry

DATASET_REGISTRY = Registry(registry_name="torch_dataset", base_class=BaseDataset)


def arguments_dataset(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser = BaseDataset.add_arguments(parser)
    return DATASET_REGISTRY.all_arguments(parser)


def build_dataset_from_registry(opts, is_training: bool = True, is_evaluation: bool = False,
                                *args, **kwargs):
    return DATASET_REGISTRY[getattr(opts, "dataset.name"), getattr(opts, "dataset.category")](
        opts, is_training=is_training, is_evaluation=is_evaluation, *args, **kwargs)


def get_train_val_datasets(opts):
    train_ds = build_dataset_from_registry(opts, is_training=True)
    if getattr(opts, "dataset.disable_val", False):
        return train_ds, None
    return train_ds, build_dataset_from_registry(opts, is_training=False)


def get_test_dataset(opts):
    return build_dataset_from_registry(opts, is_training=False, is_evaluation=True)


# registers the ported datasets (after DATASET_REGISTRY exists)
from cvnets_tpu_torch.data.datasets.classification import imagenet  # noqa: E402,F401
from cvnets_tpu_torch.data.datasets.detection import coco_ssd  # noqa: E402,F401
from cvnets_tpu_torch.data.datasets.segmentation import ade20k  # noqa: E402,F401
