"""COCO detection base (counterpart of cvnets_tpu/data/datasets/detection/coco_base.py):
``COCOIndex``, an index of an ``instances_*.json`` read with the standard
library's json (no pycocotools), and ``COCODetection``: the images of
``<root>/{train,val}2017`` (a training set keeps the images with at least one
annotation), category ids mapped to contiguous labels with 0 the background
(unless ``--dataset.detection.no-background-id``), and each image's boxes as
corner-form pixels, crowd boxes and boxes under a pixel dropped and the rest
clipped to the image."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from cvnets_tpu_torch.data.datasets.dataset_base import BaseImageDataset
from cvnets_tpu_torch.utils import logger


class COCOIndex:
    """Images, annotations by image, and categories of an instances json."""

    def __init__(self, ann_file: str) -> None:
        with open(ann_file) as f:
            blob = json.load(f)
        self.images = {im["id"]: im for im in blob.get("images", [])}
        self.cats = {c["id"]: c for c in blob.get("categories", [])}
        self.img_to_anns: Dict[int, List[Dict]] = {im_id: [] for im_id in self.images}
        for ann in blob.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    def image_ids(self) -> List[int]:
        return sorted(self.images.keys())

    def load_image_info(self, img_id: int) -> Dict:
        return self.images[img_id]

    def load_anns(self, img_id: int) -> List[Dict]:
        return self.img_to_anns.get(img_id, [])

    def category_ids(self) -> List[int]:
        return sorted(self.cats.keys())


class COCODetection(BaseImageDataset):
    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        split = "train" if is_training else "val"
        ann_file = os.path.join(self.root, "annotations", f"instances_{split}2017.json")
        if not os.path.isfile(ann_file):
            logger.error(f"COCO annotation file not found: {ann_file}")
        self.coco = COCOIndex(ann_file)
        self.img_dir = os.path.join(self.root, f"{split}2017")
        self.ids = [img_id for img_id in self.coco.image_ids()
                    if not is_training or len(self.coco.load_anns(img_id)) > 0]
        offset = 0 if getattr(opts, "dataset.detection.no_background_id", False) else 1
        self.coco_id_to_contiguous_id = {c: i + offset
                                         for i, c in enumerate(self.coco.category_ids())}
        self.contiguous_id_to_coco_id = {v: k for k, v in self.coco_id_to_contiguous_id.items()}
        self.n_classes = len(self.coco_id_to_contiguous_id) + offset

    def share_dataset_arguments(self) -> Dict:
        return {"model.detection.n_classes": self.n_classes}

    def __len__(self) -> int:
        return len(self.ids)

    def image_path(self, image_id: int) -> str:
        return os.path.join(self.img_dir, self.coco.load_image_info(image_id)["file_name"])

    def get_boxes_and_labels(self, image_id: int, image_width: int, image_height: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """(N, 4) float32 corner-form pixels and (N,) int64 labels; the
        instance masks of the JAX method wait with Mask R-CNN (ROADMAP.md
        queue 1 item 10)."""
        boxes, labels = [], []
        for ann in self.coco.load_anns(image_id):
            if ann.get("iscrowd", 0):
                continue
            x, y, w, h = ann["bbox"]
            if w < 1 or h < 1:
                continue
            x2, y2 = min(x + w, image_width), min(y + h, image_height)
            x, y = max(0, x), max(0, y)
            if x2 <= x or y2 <= y:
                continue
            boxes.append([x, y, x2, y2])
            labels.append(self.coco_id_to_contiguous_id[ann["category_id"]])
        return np.asarray(boxes, np.float32).reshape(-1, 4), np.asarray(labels, np.int64)
