"""ImageFolder-backed classification dataset (counterpart of
cvnets_tpu/data/datasets/classification/base_image_classification_dataset.py):
a directory a class in sorted order, the training subset of
``--dataset.percentage-of-samples`` or ``--dataset.num-samples-per-category``
(a ``np.random.default_rng`` on the seed, per class), a corrupt image read as
zeros with label -1 (the collate replaces it), and the train and validation
transform chains at the sampler's crop size.

An item comes in two parts so that the loader can draw every random parameter
in sample order before its threads decode: ``draw_params(t, rng)`` probes the
image's size (its header) and draws the transforms' parameters from ``rng``;
``get_item(t, params)`` reads the image and transforms it. ``dataset[t]`` does
both with the dataset's own ``random.Random``.

Not ported: the native decoder's fast paths (``_native_fast_path``,
``fetch_batch_native``) and the host AutoAugment and timm RandAugment, which
run on Pillow (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.constants import SUPPORTED_IMAGE_EXTNS
from cvnets_tpu_torch.data.datasets.dataset_base import BaseImageDataset
from cvnets_tpu_torch.data.transforms.common import Compose
from cvnets_tpu_torch.data.transforms.image import (
    CenterCrop,
    RandomHorizontalFlip,
    RandomResizedCrop,
    Resize,
    ToFloatTensor,
)
from cvnets_tpu_torch.utils import logger

# host-tier policies of the JAX package that run on Pillow
_UNPORTED_HOST_AUGMENTATION = ("image_augmentation.auto_augment.enable",
                               "image_augmentation.rand_augment.use_timm_library")


def _find_classes(root: str) -> Tuple[List[str], Dict[str, int]]:
    classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
    return classes, {c: i for i, c in enumerate(classes)}


class BaseImageClassificationDataset(BaseImageDataset):
    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        for dest in _UNPORTED_HOST_AUGMENTATION:
            if is_training and getattr(opts, dest, False):
                raise NotImplementedError(
                    f"not ported yet: --{dest.replace('_', '-')} runs on Pillow in the "
                    "JAX package (ROADMAP.md queue 1 item 13)")
        self.samples = self._subset(self._find_samples())
        self.n_classes = len(self.classes)
        self._rng = random.Random(getattr(opts, "common.seed", 0) or 0)
        self._chains: Dict[Tuple[int, int], Compose] = {}

    def _find_samples(self) -> List[Tuple[str, int]]:
        root = self.root
        if not root or not os.path.isdir(root):
            logger.error(f"Classification dataset root not found: {root!r}")
        self.classes, self.class_to_idx = _find_classes(root)
        samples = []
        for cls_name in self.classes:
            for dirpath, _, files in sorted(os.walk(os.path.join(root, cls_name))):
                samples += [(os.path.join(dirpath, f), self.class_to_idx[cls_name])
                            for f in sorted(files)
                            if os.path.splitext(f)[1].lower() in SUPPORTED_IMAGE_EXTNS]
        return samples

    def _subset(self, samples: List[Tuple[str, int]]) -> List[Tuple[str, int]]:
        """The training subset, drawn class by class in order of first appearance."""
        opts = self.opts
        pct = getattr(opts, "dataset.percentage_of_samples", 100.0) or 100.0
        n_per_cat = getattr(opts, "dataset.num_samples_per_category", -1) or -1
        if not self.is_training or (pct >= 100.0 and n_per_cat <= 0):
            return samples
        if n_per_cat > 0 and 0 < pct < 100:
            logger.error("Specify only one of dataset.num_samples_per_category and "
                         "dataset.percentage_of_samples")
        seed = getattr(opts, "dataset.sample_selection_random_seed", None)
        if seed is None:
            seed = getattr(opts, "common.seed", 0) or 0
        rng = np.random.default_rng(seed)
        by_class: Dict[int, List] = {}
        for s in samples:
            by_class.setdefault(s[1], []).append(s)
        keep = []
        for cls_samples in by_class.values():
            n_keep = (min(n_per_cat, len(cls_samples)) if n_per_cat > 0
                      else max(1, int(len(cls_samples) * pct / 100.0)))
            keep += [cls_samples[i] for i in rng.permutation(len(cls_samples))[:n_keep]]
        return keep

    def share_dataset_arguments(self) -> Dict:
        return {"model.classification.n_classes": self.n_classes}

    def _training_transforms(self, size: Tuple[int, int]) -> Compose:
        opts = self.opts
        transforms = [RandomResizedCrop(opts, size=size)
                      if getattr(opts, "image_augmentation.random_resized_crop.enable", False)
                      else Resize(opts, img_size=list(size))]
        if getattr(opts, "image_augmentation.random_horizontal_flip.enable", False):
            transforms.append(RandomHorizontalFlip(opts))
        return Compose(opts, transforms + [ToFloatTensor(opts)])

    def _validation_transforms(self, size: Tuple[int, int]) -> Compose:
        opts = self.opts
        transforms = []
        if getattr(opts, "image_augmentation.resize.enable", False):
            transforms.append(Resize(opts))
        transforms.append(CenterCrop(opts)
                          if getattr(opts, "image_augmentation.center_crop.enable", False)
                          else Resize(opts, img_size=list(size)))
        return Compose(opts, transforms + [ToFloatTensor(opts)])

    def _chain(self, size: Tuple[int, int]) -> Compose:
        if size not in self._chains:
            self._chains[size] = (self._training_transforms(size) if self.is_training
                                  else self._validation_transforms(size))
        return self._chains[size]

    def __len__(self) -> int:
        return len(self.samples)

    def image_size(self, idx: int) -> Optional[Tuple[int, int]]:
        return self.image_size_pil(self.samples[idx][0])

    def read_image(self, idx: int) -> Optional[np.ndarray]:
        return self.read_image_pil(self.samples[idx][0])

    def _crop_size(self, sample_size_and_index) -> Tuple[int, int, int]:
        crop_h, crop_w, idx = self._parse_batch_tuple(sample_size_and_index)
        return (224, 224, idx) if crop_h <= 0 else (crop_h, crop_w, idx)

    def draw_params(self, sample_size_and_index, rng: random.Random):
        """The transforms' parameters for one item, or None (and no draw) for an
        image that cannot be read, as the JAX dataset draws nothing for one."""
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        size = self.image_size(idx)
        return None if size is None else self._chain((crop_h, crop_w)).draw(rng, size)[0]

    def get_item(self, sample_size_and_index, params) -> Dict:
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        target = self.samples[idx][1]
        img = self.read_image(idx) if params is not None else None
        if img is None:
            return {"samples": torch.zeros((3, crop_h, crop_w), dtype=torch.uint8),
                    "targets": -1, "sample_id": idx}
        data = self._chain((crop_h, crop_w)).apply(
            {"image": torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)}, params)
        arr = data["image"]
        if tuple(arr.shape[-2:]) != (crop_h, crop_w):  # every sample of a batch one shape
            from cvnets_tpu_torch.data.transforms.image import resize_image

            arr = resize_image(arr, (crop_h, crop_w))
        return {"samples": arr, "targets": int(target), "sample_id": idx}

    def __getitem__(self, sample_size_and_index) -> Dict:
        return self.get_item(sample_size_and_index,
                             self.draw_params(sample_size_and_index, self._rng))
