"""Large Scale Jitter (counterpart of the ``scale_jitter`` and
``fixed_size_crop`` transforms of cvnets_tpu/data/transforms/image_advanced.py,
:136 and :175; arXiv:2012.07177), the Mask R-CNN LSJ recipe's pair.

``ScaleJitter`` resizes to ``min(target_w / w, target_h / h)`` times a
uniform scale in ``scale_range`` (the reference's and JAX's indexing:
``min(target[1] / h, target[0] / w)``), ``FixedSizeCrop`` crops a random
window of the fixed size where the image is larger (one draw for both axes,
as JAX) and pads the bottom and right with ``fill`` where it is smaller.
Their draws are taken in the loader's producer thread (``draw``), in JAX's
order. Boxes move with the image; a crop drops the boxes it empties, and
with them their labels and the sample's ``instance_ids``; the sample's
``InstanceGeometry`` (its instance polygons) moves too.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import numpy as np
import torch.nn.functional as F

from cvnets_tpu_torch.data.transforms import TRANSFORMATIONS_REGISTRY
from cvnets_tpu_torch.data.transforms.common import BaseTransformation
from cvnets_tpu_torch.data.transforms.image import move_geometry, resize_image


def _setup_size(size, default=None) -> Optional[Tuple[int, int]]:
    if size is None:
        return default
    if isinstance(size, int):
        return size, size
    if len(size) == 1:
        return int(size[0]), int(size[0])
    return int(size[0]), int(size[1])


@TRANSFORMATIONS_REGISTRY.register(name="scale_jitter", type="image_pil")
class ScaleJitter(BaseTransformation):
    def __init__(self, opts, target_size=None, **kwargs) -> None:
        """``target_size`` is taken where the options give none (the dataset
        passes its crop size, as the JAX dataset sets the option)."""
        super().__init__(opts)
        prefix = "image_augmentation.scale_jitter."
        self.target_size = _setup_size(getattr(opts, prefix + "target_size", None)
                                       or target_size, (1024, 1024))
        self.scale_range = tuple(getattr(opts, prefix + "scale_range", None) or (0.1, 2.0))
        self.interpolation = getattr(opts, prefix + "interpolation", "bilinear")

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        prefix = "--image-augmentation.scale-jitter."
        group.add_argument(prefix + "enable", action="store_true", default=False)
        group.add_argument(prefix + "interpolation", type=str, default="bilinear")
        group.add_argument(prefix + "target-size", type=int, nargs="+", default=None)
        group.add_argument(prefix + "scale-range", type=float, nargs="+", default=None)
        return parser

    def draw(self, rng, size_hw):
        h, w = size_hw
        lo, hi = self.scale_range
        scale = lo + rng.random() * (hi - lo)
        r = min(self.target_size[1] / h, self.target_size[0] / w) * scale
        out = (int(h * r), int(w * r))
        return out, out

    def apply(self, data: Dict, params) -> Dict:
        old_h, old_w = data["image"].shape[-2:]
        new_h, new_w = params
        if "box_coordinates" in data:
            boxes = np.array(data["box_coordinates"], dtype=np.float32)
            boxes[..., 0::2] *= new_w / max(old_w, 1)
            boxes[..., 1::2] *= new_h / max(old_h, 1)
            data["box_coordinates"] = boxes
        move_geometry(data, "scale", new_w, old_w, new_h, old_h)
        data["image"] = resize_image(data["image"], (new_h, new_w), self.interpolation)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="fixed_size_crop", type="image_pil")
class FixedSizeCrop(BaseTransformation):
    def __init__(self, opts, size=None, **kwargs) -> None:
        super().__init__(opts)
        prefix = "image_augmentation.fixed_size_crop."
        if size is None:
            size = getattr(opts, prefix + "size", None)
        self.crop_height, self.crop_width = _setup_size(size, (1024, 1024))
        self.fill = getattr(opts, prefix + "fill", 0)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        prefix = "--image-augmentation.fixed-size-crop."
        group.add_argument(prefix + "enable", action="store_true", default=False)
        group.add_argument(prefix + "size", type=int, nargs="+", default=None)
        group.add_argument(prefix + "fill", type=int, default=0)
        group.add_argument(prefix + "padding-mode", type=str, default="constant")
        return parser

    def draw(self, rng, size_hw):
        """(top, left, height, width) of the crop, or None where none is needed."""
        h, w = size_hw
        new_h, new_w = min(h, self.crop_height), min(w, self.crop_width)
        crop = None
        if new_h != h or new_w != w:
            r = rng.random()
            crop = (int(max(h - self.crop_height, 0) * r), int(max(w - self.crop_width, 0) * r),
                    new_h, new_w)
        return crop, (self.crop_height, self.crop_width)

    def apply(self, data: Dict, params) -> Dict:
        if params is not None:
            top, left, height, width = params
            data["image"] = data["image"][:, top:top + height, left:left + width]
            move_geometry(data, "shift", -left, -top)
            if "box_coordinates" in data:
                boxes = np.array(data["box_coordinates"], dtype=np.float32)
                boxes[..., 0::2] = np.clip(boxes[..., 0::2] - left, 0, width)
                boxes[..., 1::2] = np.clip(boxes[..., 1::2] - top, 0, height)
                keep = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
                data["box_coordinates"] = boxes[keep]
                for key in ("box_labels", "instance_ids"):
                    if key in data:
                        data[key] = np.asarray(data[key])[keep]
        h, w = data["image"].shape[-2:]
        pad_bottom, pad_right = max(self.crop_height - h, 0), max(self.crop_width - w, 0)
        if pad_bottom or pad_right:
            data["image"] = F.pad(data["image"], (0, pad_right, 0, pad_bottom),
                                  value=self.fill)
        return data
