"""COCO for SSD (counterpart of cvnets_tpu/data/datasets/detection/coco_ssd.py):
boxes matched to the anchors of the sampler's crop size on the host, per
sample, into fixed-size per-anchor targets.

Training runs the JAX chain, ``SSDCroping`` → ``PhotometricDistort`` →
``Resize`` to the crop size → ``RandomHorizontalFlip``; validation resizes;
the offline evaluation keeps each image's own size unless
``--evaluation.detection.resize-input-images``. As the other datasets of the
port, an item comes in two parts: ``draw_params`` in the loader's producer
thread (the crop's draws need the image's size, read from its file header,
and its boxes, from the annotation index), then ``get_item`` in a worker. An
image that cannot be read is a black crop with no boxes (every anchor
background), drawn for nothing. An item is ``{"samples": uint8 (3, H, W),
"targets": {"box_labels": int64 (P,), "box_coordinates": float32 (P, 4),
"image_id", "image_width", "image_height"}}``.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.data.collate import COLLATE_FN_REGISTRY
from cvnets_tpu_torch.data.collate.collate_functions import default_collate_fn
from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
from cvnets_tpu_torch.data.datasets.detection.coco_base import COCODetection
from cvnets_tpu_torch.data.transforms.image import (
    PhotometricDistort,
    RandomHorizontalFlip,
    Resize,
    SSDCroping,
)
from cvnets_tpu_torch.models.detection.ssd import anchor_generator_and_matcher, anchors_for


@DATASET_REGISTRY.register(name="coco_ssd", type="detection")
class COCOSSDDataset(COCODetection):
    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        self.anchor_box_generator, self.match_prior = anchor_generator_and_matcher(opts)
        self.ssd_crop, self.distort = SSDCroping(opts), PhotometricDistort(opts)
        self.flip = RandomHorizontalFlip(opts)
        self.native_size = is_evaluation and not getattr(
            opts, "evaluation.detection.resize_input_images", False)
        self._rng = random.Random(getattr(opts, "common.seed", 0) or 0)

    def generate_anchors(self, height: int, width: int) -> np.ndarray:
        return anchors_for(self.anchor_box_generator, height, width)

    def _crop_size(self, sample_size_and_index) -> Tuple[int, int, int]:
        crop_h, crop_w, idx = self._parse_batch_tuple(sample_size_and_index)
        return (320, 320, idx) if crop_h <= 0 else (crop_h, crop_w, idx)

    def image_size(self, idx: int) -> Optional[Tuple[int, int]]:
        return self.image_size_pil(self.image_path(self.ids[idx]))

    def read_image(self, idx: int) -> Optional[np.ndarray]:
        return self.read_image_pil(self.image_path(self.ids[idx]))

    def draw_params(self, sample_size_and_index, rng: random.Random):
        """The training chain's draws (crop, distortion, flip), or None (and no
        draw) outside training or for an image whose header cannot be read."""
        _, _, idx = self._crop_size(sample_size_and_index)
        size = self.image_size(idx) if self.is_training else None
        if size is None:
            return None
        boxes, _ = self.get_boxes_and_labels(self.ids[idx], size[1], size[0])
        crop = self.ssd_crop.draw_crop(rng, size, boxes)
        distort, _ = self.distort.draw(rng, size)
        flip, _ = self.flip.draw(rng, size)
        return crop, distort, flip

    def get_item(self, sample_size_and_index, params) -> Dict:
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        image_id = self.ids[idx]
        img = self.read_image(idx) if params is not None or not self.is_training else None
        if img is None:
            image = torch.zeros((3, crop_h, crop_w), dtype=torch.uint8)
            boxes, labels = np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
        else:
            h, w = img.shape[:2]
            boxes, labels = self.get_boxes_and_labels(image_id, w, h)
            data = {"image": torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1),
                    "box_coordinates": boxes, "box_labels": labels}
            if self.is_training:
                crop, distort, flip = params
                data = self.ssd_crop.apply_crop(data, crop)
                data = self.distort.apply(data, distort)
                data = Resize(self.opts, img_size=[crop_h, crop_w]).apply(data, None)
                data = self.flip.apply(data, flip)
            elif not self.native_size:
                data = Resize(self.opts, img_size=[crop_h, crop_w]).apply(data, None)
            image, boxes, labels = (data["image"].contiguous(), data["box_coordinates"],
                                    data["box_labels"])
        if boxes.size:  # the matcher takes corners in [0, 1] of the crop size
            boxes = boxes / np.asarray([crop_w, crop_h, crop_w, crop_h], np.float32)
        gt_locations, gt_labels = self.match_prior(boxes, labels,
                                                   self.generate_anchors(crop_h, crop_w))
        info = self.coco.load_image_info(image_id)
        return {"samples": image,
                "targets": {"box_labels": torch.from_numpy(gt_labels),
                            "box_coordinates": torch.from_numpy(gt_locations),
                            "image_id": int(image_id),
                            "image_width": int(info.get("width", crop_w)),
                            "image_height": int(info.get("height", crop_h))}}

    def __getitem__(self, sample_size_and_index) -> Dict:
        return self.get_item(sample_size_and_index,
                             self.draw_params(sample_size_and_index, self._rng))


@COLLATE_FN_REGISTRY.register(name="coco_ssd_collate_fn")
def coco_ssd_collate_fn(batch: List[Dict], opts=None) -> Dict:
    return default_collate_fn(batch, opts)
