"""ImageNet and the sets scored with ImageNet models (counterpart of
cvnets_tpu/data/datasets/classification/imagenet.py): ``imagenet``; the
distribution-shift sets ``imagenet_a``, ``imagenet_r`` and ``imagenet_sketch``,
whose classes are wnid folders, a subset of ImageNet-1k's, and whose logits
the Evaluator projects onto that subset (``stats.logit_subset_indices``);
``imagenet_v2``, whose folders are ImageNet's class indices; ``places365``."""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
from cvnets_tpu_torch.data.datasets.classification.base_image_classification_dataset import (
    BaseImageClassificationDataset,
)


@DATASET_REGISTRY.register(name="imagenet", type="classification")
class ImageNetDataset(BaseImageClassificationDataset):
    """ImageNet-1k in ImageFolder layout (train/<wnid>/*.JPEG)."""


class BaseImageNetShiftDataset(BaseImageClassificationDataset):
    """A shift set evaluated with a 1000-class model: its classes are a subset
    of ImageNet-1k's, whose order is the sorted wnids. The subset's indices in
    that order come from ``--dataset.imagenet-shift.wnid-file`` (one wnid a
    line, in ImageNet's order) or, without one, the training root's class
    folders."""

    def _full_wnid_order(self) -> Optional[List[str]]:
        wnid_file = getattr(self.opts, "dataset.imagenet_shift.wnid_file", None)
        if wnid_file and os.path.isfile(wnid_file):
            with open(wnid_file) as f:
                return [line.strip() for line in f if line.strip()]
        train_root = getattr(self.opts, "dataset.root_train", None)
        if train_root and os.path.isdir(train_root):
            return sorted(d.name for d in os.scandir(train_root) if d.is_dir())
        return None

    def share_dataset_arguments(self) -> Dict:
        """The subset's ImageNet indices when every class is found; the model
        keeps its 1000 classes."""
        full = self._full_wnid_order()
        if not full:
            return {}
        rank = {w: i for i, w in enumerate(full)}
        subset = [rank[c] for c in self.classes if c in rank]
        return {"stats.logit_subset_indices": subset} if len(subset) == len(self.classes) \
            else {}


@DATASET_REGISTRY.register(name="imagenet_a", type="classification")
class ImageNetADataset(BaseImageNetShiftDataset):
    """ImageNet-A, natural adversarial examples (200 classes)."""


@DATASET_REGISTRY.register(name="imagenet_r", type="classification")
class ImageNetRDataset(BaseImageNetShiftDataset):
    """ImageNet-R, renditions (200 classes)."""


@DATASET_REGISTRY.register(name="imagenet_sketch", type="classification")
class ImageNetSketchDataset(BaseImageNetShiftDataset):
    """ImageNet-Sketch (all 1000 classes)."""


@DATASET_REGISTRY.register(name="imagenet_v2", type="classification")
class ImageNetV2Dataset(BaseImageClassificationDataset):
    """ImageNetV2's test sets: all 1000 classes in folders named by their
    index in ImageNet's order ("0" to "999"), relabelled by that number (the
    folders sort "0", "1", "10", ...). ``--dataset.imagenet-v2.split`` picks
    the extracted split's folder under the root; a root that is a split's
    folder is read as it is."""

    SPLIT_FOLDERS = {
        "matched-frequency": "imagenetv2-matched-frequency-format-val",
        "threshold-0.7": "imagenetv2-threshold0.7-format-val",
        "top-images": "imagenetv2-top-images-format-val",
    }

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls is not ImageNetV2Dataset:
            return parser
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--dataset.imagenet-v2.split", type=str, default=None,
                           choices=list(cls.SPLIT_FOLDERS),
                           help="ImageNetV2 variant subfolder under the root")
        return parser

    def _dataset_root(self) -> Optional[str]:
        root = super()._dataset_root()
        split = getattr(self.opts, "dataset.imagenet_v2.split", None)
        if root and split in self.SPLIT_FOLDERS:
            candidate = os.path.join(root, self.SPLIT_FOLDERS[split])
            if os.path.isdir(candidate):
                return candidate
        return root

    def __init__(self, opts, *args, **kwargs) -> None:
        super().__init__(opts, *args, **kwargs)
        if self.classes and all(c.isdigit() for c in self.classes):
            remap = {i: int(c) for i, c in enumerate(self.classes)}
            self.samples = [(p, remap[t]) for p, t in self.samples]
            self.classes = sorted(self.classes, key=int)


@DATASET_REGISTRY.register(name="places365", type="classification")
class Places365Dataset(BaseImageClassificationDataset):
    """Places365 scene classification in ImageFolder layout."""
