"""Host-tier image transforms of the classification recipes (counterpart of the
part of cvnets_tpu/data/transforms/image.py they use): random resized crop,
horizontal flip, resize, center crop, and ``ToFloatTensor``, which keeps uint8
pixels (the train step divides by 255 on the card).

Images are CHW uint8 tensors. The JAX transforms resample through Pillow's
``Image.resize``; ``resize_image`` does so with two ``F.interpolate`` calls with
``antialias=True`` (Pillow's filters, bicubic's a = -0.5), first along W, then
along H, rounding half up and clamping to uint8 after each as Pillow does, which
lands within 1/255 of Pillow on every pixel.
"""

from __future__ import annotations

import argparse
import math
import random
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from cvnets_tpu_torch.data.transforms import TRANSFORMATIONS_REGISTRY
from cvnets_tpu_torch.data.transforms.common import BaseTransformation

_MODES = ("bilinear", "bicubic")


def resize_image(img: torch.Tensor, size_hw: Tuple[int, int],
                 interpolation: str = "bilinear") -> torch.Tensor:
    """``img`` (C, H, W) uint8 resampled to ``size_hw``, as Pillow's
    ``Image.resize`` with the same filter (within 1/255)."""
    if interpolation not in _MODES:
        raise ValueError(f"interpolation {interpolation!r}: the port resamples with "
                         f"{', '.join(_MODES)}")
    h, w = size_hw
    x = img.unsqueeze(0).float()
    for size in ((x.shape[-2], w), (h, w)):  # Pillow's order: W, then H
        if tuple(x.shape[-2:]) != size:
            x = F.interpolate(x, size=size, mode=interpolation, align_corners=False,
                              antialias=True)
            x = x.add_(0.5).floor_().clamp_(0, 255)
    return x[0].to(torch.uint8)


@TRANSFORMATIONS_REGISTRY.register(name="random_resized_crop", type="image_pil")
class RandomResizedCrop(BaseTransformation):
    """Random scale and aspect crop, then resize to ``size``."""

    def __init__(self, opts, size=None, **kwargs) -> None:
        super().__init__(opts)
        self.scale = tuple(getattr(opts, "image_augmentation.random_resized_crop.scale",
                                   (0.08, 1.0)) or (0.08, 1.0))
        self.ratio = tuple(getattr(opts,
                                   "image_augmentation.random_resized_crop.aspect_ratio",
                                   (3.0 / 4.0, 4.0 / 3.0)) or (3.0 / 4.0, 4.0 / 3.0))
        self.interpolation = getattr(
            opts, "image_augmentation.random_resized_crop.interpolation", "bilinear")
        self.size = tuple(size)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--image-augmentation.random-resized-crop.enable",
                           action="store_true", default=False)
        group.add_argument("--image-augmentation.random-resized-crop.interpolation",
                           type=str, default="bilinear")
        group.add_argument("--image-augmentation.random-resized-crop.scale",
                           type=float, nargs="+", default=(0.08, 1.0))
        group.add_argument("--image-augmentation.random-resized-crop.aspect-ratio",
                           type=float, nargs="+", default=(3.0 / 4.0, 4.0 / 3.0))
        return parser

    def get_params(self, height: int, width: int, rng: random.Random
                   ) -> Tuple[int, int, int, int]:
        """(top, left, h, w) of the crop: the JAX transform's draws, from ``rng``."""
        area = height * width
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= width and 0 < h <= height:
                return rng.randint(0, height - h), rng.randint(0, width - w), h, w
        # fallback: a center crop
        in_ratio = width / height
        if in_ratio < self.ratio[0]:
            w, h = width, int(round(width / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            h, w = height, int(round(height * self.ratio[1]))
        else:
            w, h = width, height
        return (height - h) // 2, (width - w) // 2, h, w

    def draw(self, rng, size_hw):
        return self.get_params(*size_hw, rng), self.size

    def output_size(self, size_hw):
        return self.size

    def apply(self, data: Dict, params) -> Dict:
        i, j, h, w = params
        data["image"] = resize_image(data["image"][:, i:i + h, j:j + w], self.size,
                                     self.interpolation)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="random_horizontal_flip", type="image_pil")
class RandomHorizontalFlip(BaseTransformation):
    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.p = getattr(opts, "image_augmentation.random_horizontal_flip.p", 0.5)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--image-augmentation.random-horizontal-flip.enable",
                           action="store_true", default=False)
        group.add_argument("--image-augmentation.random-horizontal-flip.p", type=float,
                           default=0.5)
        return parser

    def draw(self, rng, size_hw):
        return rng.random() < self.p, size_hw

    def apply(self, data: Dict, params) -> Dict:
        if params:
            data["image"] = data["image"].flip(-1)
        return data


def _int_size(size):
    """An int, or the one entry of a one-entry list (``nargs="+"`` flags)."""
    if isinstance(size, (list, tuple)) and len(size) == 1:
        return size[0]
    return size


@TRANSFORMATIONS_REGISTRY.register(name="resize", type="image_pil")
class Resize(BaseTransformation):
    """The shorter side to ``size`` (an int), or exactly (h, w)."""

    def __init__(self, opts, img_size=None, **kwargs) -> None:
        super().__init__(opts)
        self.size = _int_size(img_size if img_size is not None
                              else getattr(opts, "image_augmentation.resize.size", 256))
        self.interpolation = getattr(opts, "image_augmentation.resize.interpolation",
                                     "bilinear")

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--image-augmentation.resize.enable", action="store_true",
                           default=False)
        group.add_argument("--image-augmentation.resize.size", type=int, nargs="+",
                           default=256)
        group.add_argument("--image-augmentation.resize.interpolation", type=str,
                           default="bilinear")
        return parser

    def output_size(self, size_hw):
        if not isinstance(self.size, int):
            return tuple(self.size)
        height, width = size_hw
        scale = self.size / min(height, width)
        if width <= height:
            return int(round(height * scale)), self.size
        return self.size, int(round(width * scale))

    def apply(self, data: Dict, params) -> Dict:
        img = data["image"]
        data["image"] = resize_image(img, self.output_size(tuple(img.shape[-2:])),
                                     self.interpolation)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="center_crop", type="image_pil")
class CenterCrop(BaseTransformation):
    """A ``size`` × ``size`` crop at the center; past the image's right or
    bottom edge it is black, as Pillow's crop."""

    def __init__(self, opts, size=None, **kwargs) -> None:
        super().__init__(opts)
        size = size if size is not None else getattr(
            opts, "image_augmentation.center_crop.size", 224)
        self.size = size[0] if isinstance(size, (list, tuple)) else size

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--image-augmentation.center-crop.enable", action="store_true",
                           default=False)
        group.add_argument("--image-augmentation.center-crop.size", type=int, nargs="+",
                           default=224)
        return parser

    def output_size(self, size_hw):
        return self.size, self.size

    def apply(self, data: Dict, params) -> Dict:
        img = data["image"]
        height, width = img.shape[-2:]
        i, j = max(0, (height - self.size) // 2), max(0, (width - self.size) // 2)
        img = img[:, i:i + self.size, j:j + self.size]
        data["image"] = F.pad(img, (0, self.size - img.shape[-1], 0, self.size - img.shape[-2]))
        return data


@TRANSFORMATIONS_REGISTRY.register(name="to_tensor", type="image_pil")
class ToFloatTensor(BaseTransformation):
    """Three channels of uint8 pixels: the [0, 1] division runs on the card in
    the train step (the JAX package's native-loader path; its Pillow path divides
    here)."""

    def apply(self, data: Dict, params) -> Dict:
        img = data["image"]
        if img.shape[0] == 1:
            img = img.expand(3, -1, -1)
        data["image"] = img.contiguous()
        return data
