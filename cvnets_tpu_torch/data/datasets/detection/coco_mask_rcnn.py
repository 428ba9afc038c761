"""COCO for Mask R-CNN (counterpart of
cvnets_tpu/data/datasets/detection/coco_mask_rcnn.py and its collate): fixed-
size targets an image, boxes (MAX_GT, 4) in the crop's pixels, labels
(MAX_GT,) with 0 for padding, and instance masks (MAX_GT, H/4, W/4) bool,
rasterized from the COCO polygons by an even-odd scanline fill
(``rasterize_polygon``, JAX's, no pycocotools).

Training resizes to the sampler's crop size and flips, or, under
``--dataset.detection.coco-mask-rcnn.use-lsj-aug``, runs Large Scale Jitter
(``ScaleJitter`` to the crop size, ``FixedSizeCrop``, flip); validation
resizes. The draws are taken in the loader's producer thread
(``draw_params``, from the image's header size), the work in a worker
(``get_item``).

The masks follow every geometric transform of the image and its boxes: each
polygon's points are mapped by the sample's ``InstanceGeometry`` (resize,
flip, jitter, crop) and rasterized at a quarter of the crop size, and a crop
that drops a box drops its label and mask with it. The JAX dataset
rasterizes the original polygons scaled by the mask's size over the
original image's, after transforms that move only the image and boxes: a
flipped or jittered sample's mask is mirrored or misplaced there, and where a
crop drops a box its item raises (its untransformed labels outnumber the
kept boxes). On a sample no flip,
jitter or crop moves, the targets are the JAX dataset's. An annotation
without polygons (RLE, or none) takes its box's region, as in JAX.

An item is ``{"samples": {"image": uint8 (3, H, W), "targets":
{"box_coordinates", "box_labels", "masks"}}, "targets": {"image_id",
"image_width", "image_height"}}``: the model reads its targets from the
samples (it computes its losses in its forward), so the masks cross to the
card once.
"""

from __future__ import annotations

import random
from fractions import Fraction
from typing import Dict, List, Sequence

import numpy as np
import torch

from cvnets_tpu_torch.data.collate import COLLATE_FN_REGISTRY
from cvnets_tpu_torch.data.collate.collate_functions import default_collate_fn
from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
from cvnets_tpu_torch.data.datasets.detection.coco_base import COCODetection
from cvnets_tpu_torch.data.transforms.common import Compose
from cvnets_tpu_torch.data.transforms.image import (
    InstanceGeometry,
    RandomHorizontalFlip,
    Resize,
)
from cvnets_tpu_torch.data.transforms.image_advanced import FixedSizeCrop, ScaleJitter
from cvnets_tpu_torch.models.detection.mask_rcnn import MAX_GT

MASK_DOWNSAMPLE = 4  # gt masks at 1/4 of the crop's resolution


def rasterize_polygon(polys: Sequence[Sequence[float]], height: int,
                      width: int) -> np.ndarray:
    """Even-odd scanline rasterization of COCO polygon lists → bool (H, W):
    a pixel is in where its center is (coco_mask_rcnn.py:29-57)."""
    mask = np.zeros((height, width), bool)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        xs, ys = pts[:, 0], pts[:, 1]
        y0 = max(0, int(np.floor(ys.min())))
        y1 = min(height - 1, int(np.ceil(ys.max())))
        x2, y2 = np.roll(xs, -1), np.roll(ys, -1)
        for row in range(y0, y1 + 1):
            yc = row + 0.5
            cond = ((ys <= yc) & (y2 > yc)) | ((y2 <= yc) & (ys > yc))
            if not cond.any():
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                x_int = xs[cond] + (yc - ys[cond]) / (y2[cond] - ys[cond]) * (
                    x2[cond] - xs[cond])
            x_int = np.sort(x_int)
            for i in range(0, len(x_int) - 1, 2):
                a = max(0, int(np.ceil(x_int[i] - 0.5)))
                b = min(width, int(np.ceil(x_int[i + 1] - 0.5)))
                if b > a:
                    mask[row, a:b] ^= True
    return mask


def instance_mask(seg, geometry: InstanceGeometry, box: np.ndarray, mask_hw,
                  crop_hw) -> np.ndarray:
    """One instance's bool mask at ``mask_hw``: its polygons mapped by
    ``geometry`` and scaled from the crop to the mask, or, without polygons,
    its (transformed) box's region."""
    (mh, mw), (ch, cw) = mask_hw, crop_hw
    sx, sy = Fraction(mw, cw), Fraction(mh, ch)
    if isinstance(seg, list) and seg:
        polys = [geometry.points(np.asarray(p, np.float64).reshape(-1, 2), sx, sy).reshape(-1)
                 for p in seg if len(p) >= 6]
        if polys:
            return rasterize_polygon(polys, mh, mw)
        return np.zeros((mh, mw), bool)
    mask = np.zeros((mh, mw), bool)
    x1, y1, x2, y2 = box * np.asarray([mw / cw, mh / ch, mw / cw, mh / ch])
    mask[int(y1):int(y2) + 1, int(x1):int(x2) + 1] = True
    return mask


@DATASET_REGISTRY.register(name="coco_mask_rcnn", type="detection")
class COCOMaskRCNNDataset(COCODetection):
    @classmethod
    def add_arguments(cls, parser):
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--dataset.detection.coco-mask-rcnn.use-lsj-aug",
                           action="store_true", default=False,
                           help="Large Scale Jitter training augmentation")
        return parser

    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        self.use_lsj = self.is_training and getattr(
            opts, "dataset.detection.coco_mask_rcnn.use_lsj_aug", False)
        self._rng = random.Random(getattr(opts, "common.seed", 0) or 0)
        self._chains: Dict[tuple, Compose] = {}

    def transforms(self, size) -> Compose:
        size = tuple(size)
        if size not in self._chains:
            if self.use_lsj:
                chain = [ScaleJitter(self.opts, target_size=list(size)),
                         FixedSizeCrop(self.opts, size=list(size)),
                         RandomHorizontalFlip(self.opts)]
            else:
                chain = [Resize(self.opts, img_size=list(size))]
                if self.is_training:
                    chain.append(RandomHorizontalFlip(self.opts))
            self._chains[size] = Compose(self.opts, chain)
        return self._chains[size]

    def _crop_size(self, sample_size_and_index):
        crop_h, crop_w, idx = self._parse_batch_tuple(sample_size_and_index)
        return (512, 512, idx) if crop_h <= 0 else (crop_h, crop_w, idx)

    def image_size(self, idx: int):
        return self.image_size_pil(self.image_path(self.ids[idx]))

    def draw_params(self, sample_size_and_index, rng: random.Random):
        """The chain's draws, or None (and no draw) for an image whose header
        cannot be read."""
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        size = self.image_size(idx)
        if size is None:
            return None
        return self.transforms((crop_h, crop_w)).draw(rng, size)[0]

    def get_item(self, sample_size_and_index, params) -> Dict:
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        image_id = self.ids[idx]
        mh, mw = crop_h // MASK_DOWNSAMPLE, crop_w // MASK_DOWNSAMPLE
        boxes_p = np.zeros((MAX_GT, 4), np.float32)
        labels_p = np.zeros((MAX_GT,), np.int64)
        masks_p = np.zeros((MAX_GT, mh, mw), bool)
        img = self.read_image_pil(self.image_path(image_id)) if params is not None else None
        if img is None:
            image = torch.zeros((3, crop_h, crop_w), dtype=torch.uint8)
        else:
            h, w = img.shape[:2]
            boxes, labels, segs = self.get_boxes_and_labels(image_id, w, h, include_masks=True)
            data = {"image": torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1),
                    "box_coordinates": boxes, "box_labels": labels,
                    "instance_ids": np.arange(len(labels)),
                    "instance_geometry": InstanceGeometry()}
            data = self.transforms((crop_h, crop_w)).apply(data, params)
            image = data["image"]
            n = min(len(data["box_labels"]), MAX_GT)
            boxes_p[:n] = data["box_coordinates"][:n]
            labels_p[:n] = data["box_labels"][:n]
            for gi, ann in enumerate(data["instance_ids"][:n]):
                masks_p[gi] = instance_mask(segs[ann], data["instance_geometry"], boxes_p[gi],
                                            (mh, mw), (crop_h, crop_w))
        info = self.coco.load_image_info(image_id)
        targets = {"box_coordinates": torch.from_numpy(boxes_p),
                   "box_labels": torch.from_numpy(labels_p),
                   "masks": torch.from_numpy(masks_p)}
        return {"samples": {"image": image.contiguous(), "targets": targets},
                "targets": {"image_id": int(image_id),
                            "image_width": int(info.get("width", crop_w)),
                            "image_height": int(info.get("height", crop_h))}}

    def __getitem__(self, sample_size_and_index) -> Dict:
        return self.get_item(sample_size_and_index,
                             self.draw_params(sample_size_and_index, self._rng))


@COLLATE_FN_REGISTRY.register(name="coco_mask_rcnn_collate_fn")
def coco_mask_rcnn_collate_fn(batch: List[Dict], opts=None) -> Dict:
    return default_collate_fn(batch, opts)
