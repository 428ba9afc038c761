"""Base segmentation dataset (counterpart of
cvnets_tpu/data/datasets/segmentation/base_segmentation.py): (image, mask)
file pairs; the training chain (random short-side resize, flip, random crop
at the sampler's size, always, as in the JAX package), the validation resize
to the crop size, the offline-eval transforms of ``--evaluation.segmentation.*``,
an unreadable pair read as a black image whose mask is all ignore label, and
a last resize to the crop's size where a chain leaves another shape.

An item is ``{"samples": uint8 (3, H, W), "targets": uint8 (H, W), "sample_id"}``:
labels 0-254 and the ignore label 255 fit a byte, so a batch's masks cross to
the card as uint8 (a quarter of the bytes of int32 ones) and the train step
widens them there. As the classification datasets, an item comes in two parts
(``draw_params`` in the loader's producer thread, in sample order, then
``get_item`` in a worker thread), so a batch never depends on thread timing;
``RandomCrop`` draws its retry offsets up front for that reason.
"""

from __future__ import annotations

import argparse
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
from cvnets_tpu_torch.data.datasets.dataset_base import BaseImageDataset
from cvnets_tpu_torch.data.transforms.common import Compose
from cvnets_tpu_torch.data.transforms.image import (
    UNPORTED_SEGMENTATION_TRANSFORMS,
    RandomCrop,
    RandomHorizontalFlip,
    RandomShortSizeResize,
    Resize,
    ToFloatTensor,
    resize_image,
    resize_mask,
)


@DATASET_REGISTRY.register(name="__base__", type="segmentation")
class BaseImageSegmentationDataset(BaseImageDataset):
    ignore_label = 255
    n_seg_classes: Optional[int] = None

    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        for dest, what in UNPORTED_SEGMENTATION_TRANSFORMS.items():
            if is_training and getattr(opts, dest, False):
                raise NotImplementedError(
                    f"not ported yet: --{dest.replace('_', '-')} ({what}; ROADMAP.md "
                    "queue 1 item 7)")
        self.images: List[str] = []
        self.masks: List[str] = []
        self._rng = random.Random(getattr(opts, "common.seed", 0) or 0)
        self._chains: Dict[Tuple[int, int], Compose] = {}

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseImageSegmentationDataset:
            return parser
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--evaluation.segmentation.mode", type=str,
                           default="validation_set",
                           choices=["single_image", "image_folder", "validation_set"])
        group.add_argument("--evaluation.segmentation.path", type=str, default=None)
        group.add_argument("--evaluation.segmentation.apply-color-map", action="store_true")
        group.add_argument("--evaluation.segmentation.save-overlay-rgb-pred",
                           action="store_true")
        group.add_argument("--evaluation.segmentation.save-masks", action="store_true")
        group.add_argument("--evaluation.segmentation.overlay-mask-weight", type=float,
                           default=0.5)
        group.add_argument("--evaluation.segmentation.resize-input-images",
                           action="store_true")
        group.add_argument("--evaluation.segmentation.resize-input-images-fixed-size",
                           type=int, nargs="+", default=None,
                           help="Resize eval inputs to this fixed (H, W) instead of the "
                                "sampler's crop size")
        return parser

    def share_dataset_arguments(self) -> Dict:
        return {"model.segmentation.n_classes": self.n_seg_classes}

    def _training_transforms(self, size: Tuple[int, int]) -> Compose:
        opts = self.opts
        return Compose(opts, [RandomShortSizeResize(opts), RandomHorizontalFlip(opts),
                              RandomCrop(opts, size=size, ignore_idx=self.ignore_label),
                              ToFloatTensor(opts)])

    def _validation_transforms(self, size: Tuple[int, int]) -> Compose:
        return Compose(self.opts, [Resize(self.opts, img_size=list(size)),
                                   ToFloatTensor(self.opts)])

    def _evaluation_transforms(self, size: Tuple[int, int]) -> Compose:
        """The shorter side to the crop's under ``resize-input-images``, exactly
        ``resize-input-images-fixed-size`` under that flag, else no resize."""
        opts = self.opts
        transforms = []
        fixed = getattr(opts, "evaluation.segmentation.resize_input_images_fixed_size", None)
        if getattr(opts, "evaluation.segmentation.resize_input_images", False):
            transforms.append(Resize(opts, img_size=min(size)))
        elif fixed:
            transforms.append(Resize(opts, img_size=list(fixed)))
        return Compose(opts, transforms + [ToFloatTensor(opts)])

    def _chain(self, size: Tuple[int, int]) -> Compose:
        if size not in self._chains:
            self._chains[size] = (self._training_transforms(size) if self.is_training
                                  else self._evaluation_transforms(size) if self.is_evaluation
                                  else self._validation_transforms(size))
        return self._chains[size]

    def __len__(self) -> int:
        return len(self.images)

    def image_size(self, idx: int) -> Optional[Tuple[int, int]]:
        """(height, width) of the pair's image, or None if the image or its
        mask cannot be read (their headers)."""
        if self.image_size_pil(self.masks[idx]) is None:
            return None
        return self.image_size_pil(self.images[idx])

    def read_image(self, idx: int) -> Optional[np.ndarray]:
        return self.read_image_pil(self.images[idx])

    def read_mask(self, idx: int) -> Optional[np.ndarray]:
        return self.read_mask_pil(self.masks[idx])

    def adjust_mask_value(self, mask: np.ndarray) -> np.ndarray:
        return mask

    def _crop_size(self, sample_size_and_index) -> Tuple[int, int, int]:
        crop_h, crop_w, idx = self._parse_batch_tuple(sample_size_and_index)
        return (512, 512, idx) if crop_h <= 0 else (crop_h, crop_w, idx)

    def draw_params(self, sample_size_and_index, rng: random.Random):
        """The chain's parameters for one item, or None (and no draw) for a pair
        that cannot be read, as the JAX dataset draws nothing for one."""
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        size = self.image_size(idx)
        return None if size is None else self._chain((crop_h, crop_w)).draw(rng, size)[0]

    def get_item(self, sample_size_and_index, params) -> Dict:
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        img = mask = None
        if params is not None:
            img, mask = self.read_image(idx), self.read_mask(idx)
        if img is None or mask is None:
            return {"samples": torch.zeros((3, crop_h, crop_w), dtype=torch.uint8),
                    "targets": torch.full((crop_h, crop_w), self.ignore_label,
                                          dtype=torch.uint8),
                    "sample_id": idx}
        mask = np.asarray(self.adjust_mask_value(mask)).astype(np.uint8)
        data = self._chain((crop_h, crop_w)).apply(
            {"image": torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1),
             "mask": torch.from_numpy(mask)}, params)
        arr, target = data["image"], data["mask"]
        if tuple(arr.shape[-2:]) != (crop_h, crop_w):  # every sample of a batch one shape
            arr = resize_image(arr, (crop_h, crop_w), "bicubic")  # Pillow's default
            target = resize_mask(target, (crop_h, crop_w))
        return {"samples": arr, "targets": target.contiguous(), "sample_id": idx}

    def __getitem__(self, sample_size_and_index) -> Dict:
        return self.get_item(sample_size_and_index,
                             self.draw_params(sample_size_and_index, self._rng))
