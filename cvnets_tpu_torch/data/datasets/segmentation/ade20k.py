"""The segmentation datasets (counterpart of
cvnets_tpu/data/datasets/segmentation/ade20k.py): ADE20k, PASCAL VOC 2012 and
COCO masks over the VOC classes, each a list of (image, mask) file pairs."""

from __future__ import annotations

import os

import numpy as np

from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
from cvnets_tpu_torch.data.datasets.segmentation.base_segmentation import (
    BaseImageSegmentationDataset,
)


@DATASET_REGISTRY.register(name="ade20k", type="segmentation")
class ADE20KDataset(BaseImageSegmentationDataset):
    """ADEChallengeData2016: ``images/{training,validation}/*.jpg`` and their
    ``annotations/…/*.png``. 150 classes: raw label 0 ("other") becomes the
    ignore label and the rest shift down by one."""

    n_seg_classes = 150

    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        split = "training" if is_training else "validation"
        img_dir = os.path.join(self.root, "images", split)
        ann_dir = os.path.join(self.root, "annotations", split)
        if os.path.isdir(img_dir):
            for fname in sorted(os.listdir(img_dir)):
                if fname.endswith(".jpg"):
                    self.images.append(os.path.join(img_dir, fname))
                    self.masks.append(os.path.join(ann_dir, fname.replace(".jpg", ".png")))

    def adjust_mask_value(self, mask: np.ndarray) -> np.ndarray:
        mask = mask.astype(np.int32) - 1
        mask[mask < 0] = self.ignore_label
        return mask


@DATASET_REGISTRY.register(name="pascal", type="segmentation")
class PascalVOCDataset(BaseImageSegmentationDataset):
    """PASCAL VOC 2012, 21 classes with the background. The pairs come from
    ``VOC2012/list/{train_aug,val}.txt`` (lines of two paths under
    ``VOC2012``, the SBD-augmented list) where it exists, else from
    ``VOC2012/ImageSets/Segmentation/{train,val}.txt`` (names of
    ``JPEGImages/*.jpg`` and ``SegmentationClass/*.png``). The COCO flags are
    parsed and, as in the JAX package, not read."""

    n_seg_classes = 21

    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        voc_root = os.path.join(self.root, "VOC2012")
        split_file = os.path.join(voc_root, "list",
                                  "train_aug.txt" if is_training else "val.txt")
        if os.path.isfile(split_file):
            with open(split_file) as f:
                for line in f:
                    parts = line.strip().split()
                    if len(parts) >= 2:
                        self.images.append(voc_root + parts[0])
                        self.masks.append(voc_root + parts[1])
            return
        names = os.path.join(voc_root, "ImageSets", "Segmentation",
                             "train.txt" if is_training else "val.txt")
        if os.path.isfile(names):
            with open(names) as f:
                for name in f.read().split():
                    self.images.append(os.path.join(voc_root, "JPEGImages", f"{name}.jpg"))
                    self.masks.append(os.path.join(voc_root, "SegmentationClass",
                                                   f"{name}.png"))

    @classmethod
    def add_arguments(cls, parser):
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--dataset.pascal.use-coco-data", action="store_true")
        group.add_argument("--dataset.pascal.coco-root-dir", type=str, default=None)
        return parser


@DATASET_REGISTRY.register(name="coco_segmentation", type="segmentation")
class COCOSegmentation(BaseImageSegmentationDataset):
    """COCO images with masks over the 21 VOC classes, rendered beforehand:
    ``masks/{train2017,val2017}/*.png`` and ``{train2017,val2017}/*.jpg``."""

    n_seg_classes = 21

    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        split = "train2017" if is_training else "val2017"
        img_dir = os.path.join(self.root, split)
        mask_dir = os.path.join(self.root, "masks", split)
        if os.path.isdir(mask_dir):
            for fname in sorted(os.listdir(mask_dir)):
                if fname.endswith(".png"):
                    self.images.append(os.path.join(img_dir, fname.replace(".png", ".jpg")))
                    self.masks.append(os.path.join(mask_dir, fname))
