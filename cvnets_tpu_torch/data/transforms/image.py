"""Host-tier image transforms of the classification and segmentation recipes
(counterpart of the part of cvnets_tpu/data/transforms/image.py they use):
random resized crop, horizontal flip, resize, center crop, random short-side
resize, random crop, and ``ToFloatTensor``, which keeps uint8 pixels (the train
step divides by 255 on the card).

Images are CHW uint8 tensors; a segmentation mask rides along as ``data["mask"]``,
an (H, W) uint8 tensor, and every geometric transform moves it with the image.
The JAX transforms resample through Pillow's ``Image.resize``; ``resize_image``
does so with two ``F.interpolate`` calls with ``antialias=True`` (Pillow's
filters, bicubic's a = -0.5), first along W, then along H, rounding half up and
clamping to uint8 after each as Pillow does, which lands within 1/255 of Pillow
on every pixel, upscaling included. Masks resize as Pillow's ``NEAREST`` does,
bit for bit (``resize_mask``): ``F.interpolate``'s "nearest-exact" picks
another source pixel for about half of the (in, out) size pairs.

Detection adds ``SSDCroping`` and ``PhotometricDistort`` (which the
segmentation chain also runs when its flag is on), and ``Resize`` and
``RandomHorizontalFlip`` move ``data["box_coordinates"]``, (N, 4) float32
numpy boxes in pixels, with the image, and ``data["instance_geometry"]``
(an ``InstanceGeometry``: where an instance polygon's original points land)
where the sample has one: Mask R-CNN's instance masks follow every
geometric transform (``data/transforms/image_advanced.py`` adds the LSJ
pair). The segmentation transforms that no
yaml of ``config/segmentation/`` turns on (Gaussian blur, rotation, random
order) are not ported: their ``enable`` flags are parsed, and a dataset asked
for one raises.
"""

from __future__ import annotations

import argparse
import functools
import math
import random
from fractions import Fraction
from typing import Dict, Tuple

import numpy as np
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


@functools.lru_cache(maxsize=256)
def _nearest_index(out_size: int, in_size: int) -> torch.Tensor:
    """Pillow's NEAREST source index of each output position: its scaling loop
    starts a double at scale / 2 and adds scale = in / out once a position,
    truncating each (an accumulated sum, not (x + 0.5) · scale)."""
    scale = in_size / out_size
    pos = np.cumsum(np.concatenate([[scale * 0.5], np.full(out_size - 1, scale)]))
    return torch.from_numpy(np.minimum(pos.astype(np.int64), in_size - 1))


def resize_mask(mask: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """``mask`` (H, W) resampled to ``size_hw`` as Pillow's ``NEAREST``."""
    h, w = size_hw
    if tuple(mask.shape) == (h, w):
        return mask
    rows, cols = _nearest_index(h, mask.shape[0]), _nearest_index(w, mask.shape[1])
    return mask.index_select(0, rows).index_select(1, cols)


def _resize(data: Dict, size_hw: Tuple[int, int], interpolation: str) -> Dict:
    """The image by ``interpolation``, the mask (if any) by nearest."""
    data["image"] = resize_image(data["image"], size_hw, interpolation)
    if data.get("mask") is not None:
        data["mask"] = resize_mask(data["mask"], size_hw)
    return data


class InstanceGeometry:
    """The map x' = ax·x + bx, y' = ay·y + by from an image's original pixels
    to its transformed ones, in exact rationals: a resize scales it, a flip
    mirrors it, a crop shifts it. ``points`` applies it, times a last scale,
    with one float multiply and add an axis, so a map of a resize alone
    gives ``x · (s_last · a)`` correctly rounded, the product the JAX
    dataset takes (``x · mw / im_w``)."""

    def __init__(self) -> None:
        self.ax, self.bx, self.ay, self.by = Fraction(1), Fraction(0), Fraction(1), Fraction(0)

    def scale(self, new_w: int, old_w: int, new_h: int, old_h: int) -> None:
        sx, sy = Fraction(new_w, max(old_w, 1)), Fraction(new_h, max(old_h, 1))
        self.ax, self.bx, self.ay, self.by = self.ax * sx, self.bx * sx, self.ay * sy, self.by * sy

    def flip(self, width: int) -> None:
        self.ax, self.bx = -self.ax, width - self.bx

    def shift(self, dx: int, dy: int) -> None:
        self.bx, self.by = self.bx + dx, self.by + dy

    def points(self, pts: np.ndarray, sx: Fraction = Fraction(1),
               sy: Fraction = Fraction(1)) -> np.ndarray:
        """(K, 2) float64 points mapped, then scaled by (sx, sy)."""
        out = pts * np.asarray([float(self.ax * sx), float(self.ay * sy)])
        if self.bx or self.by:
            out = out + np.asarray([float(self.bx * sx), float(self.by * sy)])
        return out


def move_geometry(data: Dict, method: str, *args) -> None:
    """Apply one step to the sample's ``InstanceGeometry``, if it has one."""
    geometry = data.get("instance_geometry")
    if geometry is not None:
        getattr(geometry, method)(*args)


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
            move_geometry(data, "flip", data["image"].shape[-1])
            if data.get("mask") is not None:
                data["mask"] = data["mask"].flip(-1)
            if "box_coordinates" in data:
                boxes = np.array(data["box_coordinates"], dtype=np.float32)
                boxes[:, [0, 2]] = data["image"].shape[-1] - boxes[:, [2, 0]]
                data["box_coordinates"] = boxes
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
        old_h, old_w = data["image"].shape[-2:]
        new_h, new_w = self.output_size((old_h, old_w))
        if "box_coordinates" in data:
            boxes = np.array(data["box_coordinates"], dtype=np.float32)
            boxes[:, [0, 2]] *= new_w / old_w
            boxes[:, [1, 3]] *= new_h / old_h
            data["box_coordinates"] = boxes
        move_geometry(data, "scale", new_w, old_w, new_h, old_h)
        return _resize(data, (new_h, new_w), self.interpolation)


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


@TRANSFORMATIONS_REGISTRY.register(name="random_short_size_resize", type="image_pil")
class RandomShortSizeResize(BaseTransformation):
    """The shorter side to a size drawn from [min, max], the longer side at most
    ``max_img_dim``; the new size truncated, as ``int(w * scale)``."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        prefix = "image_augmentation.random_short_size_resize."
        self.min_short = getattr(opts, prefix + "short_side_min", 256)
        self.max_short = getattr(opts, prefix + "short_side_max", 320)
        self.max_long = getattr(opts, prefix + "max_img_dim", 1024)
        self.interpolation = getattr(opts, prefix + "interpolation", "bilinear")

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        prefix = "--image-augmentation.random-short-size-resize."
        group.add_argument(prefix + "enable", action="store_true", default=False)
        group.add_argument(prefix + "short-side-min", type=int, default=256)
        group.add_argument(prefix + "short-side-max", type=int, default=320)
        group.add_argument(prefix + "max-img-dim", type=int, default=1024)
        group.add_argument(prefix + "interpolation", type=str, default="bilinear")
        return parser

    def _size(self, size_hw: Tuple[int, int], short_side: int) -> Tuple[int, int]:
        h, w = size_hw
        scale = min(short_side / min(h, w), self.max_long / max(h, w))
        return int(h * scale), int(w * scale)

    def draw(self, rng, size_hw):
        short_side = rng.randint(self.min_short, self.max_short)
        return short_side, self._size(size_hw, short_side)

    def apply(self, data: Dict, params) -> Dict:
        return _resize(data, self._size(tuple(data["image"].shape[-2:]), params),
                       self.interpolation)


@TRANSFORMATIONS_REGISTRY.register(name="random_crop", type="image_pil")
class RandomCrop(BaseTransformation):
    """A crop of ``size``. An image smaller than the crop is first scaled up
    (bilinear, its mask nearest) or, under ``pad-if-needed``, padded at the
    bottom and right with zeros (its mask with ``mask-fill``). Under
    ``seg-class-max-ratio`` an offset whose crop one class dominates is drawn
    again, up to 10 times, as the JAX transform does. Which offset passes
    depends on the mask, which is read after the draws, so ``draw`` takes all
    11 candidate offsets up front, in the order the JAX transform draws them,
    and ``apply`` keeps the first that passes (the last one if none does): the
    draws never depend on a worker thread's timing."""

    RETRIES = 10

    def __init__(self, opts, size=None, ignore_idx: int = 255, **kwargs) -> None:
        super().__init__(opts)
        self.size = tuple(size)
        self.ignore_idx = ignore_idx
        prefix = "image_augmentation.random_crop."
        self.max_ratio = getattr(opts, prefix + "seg_class_max_ratio", None)
        self.pad_if_needed = getattr(opts, prefix + "pad_if_needed", False)
        self.mask_fill = getattr(opts, prefix + "mask_fill", 255)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        prefix = "--image-augmentation.random-crop."
        group.add_argument(prefix + "enable", action="store_true", default=False)
        group.add_argument(prefix + "seg-class-max-ratio", type=float, default=None)
        group.add_argument(prefix + "pad-if-needed", action="store_true", default=False)
        group.add_argument(prefix + "mask-fill", type=int, default=255)
        return parser

    def _fit_size(self, h: int, w: int) -> Tuple[int, int]:
        """The image's size once it is at least the crop's."""
        ch, cw = self.size
        if h >= ch and w >= cw:
            return h, w
        if self.pad_if_needed:
            return max(h, ch), max(w, cw)
        scale = min(h + max(0, ch - h), w + max(0, cw - w)) / min(h, w)
        return max(ch, int(round(h * scale))), max(cw, int(round(w * scale)))

    def draw(self, rng, size_hw):
        (h, w), (ch, cw) = self._fit_size(*size_hw), self.size
        n = 1 + self.RETRIES if self.max_ratio is not None else 1
        return [(rng.randint(0, h - ch), rng.randint(0, w - cw)) for _ in range(n)], self.size

    def output_size(self, size_hw):
        return self.size

    def _fit(self, data: Dict) -> Dict:
        h, w = data["image"].shape[-2:]
        fit_h, fit_w = self._fit_size(h, w)
        if (fit_h, fit_w) == (h, w):
            return data
        if not self.pad_if_needed:
            return _resize(data, (fit_h, fit_w), "bilinear")
        pad = (0, fit_w - w, 0, fit_h - h)
        data["image"] = F.pad(data["image"], pad)
        if data.get("mask") is not None:
            data["mask"] = F.pad(data["mask"], pad, value=self.mask_fill)
        return data

    def _passes(self, crop: torch.Tensor) -> bool:
        """No class holds ``max_ratio`` or more of the crop's labelled pixels,
        and the crop holds more than one value (the ignore label counts)."""
        counts = torch.bincount(crop.flatten().long(), minlength=256).tolist()
        valid = [n for label, n in enumerate(counts) if n and label != self.ignore_idx]
        n_values = sum(1 for n in counts if n)
        return bool(valid) and n_values > 1 and max(valid) / sum(valid) < self.max_ratio

    def apply(self, data: Dict, params) -> Dict:
        data = self._fit(data)
        (ch, cw), mask = self.size, data.get("mask")
        i, j = params[0]
        if len(params) > 1 and mask is not None:
            i, j = next(((a, b) for a, b in params[:-1]
                         if self._passes(mask[a:a + ch, b:b + cw])), params[-1])
        data["image"] = data["image"][:, i:i + ch, j:j + cw]
        if mask is not None:
            data["mask"] = mask[i:i + ch, j:j + cw]
        return data


def _blend(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """Pillow's ``Image.blend(a, b, alpha)`` of uint8 images: a + alpha · (b - a)
    in float32, clipped to [0, 255] and truncated."""
    a = a.float()
    out = a + torch.tensor(alpha, dtype=torch.float32) * (b.float() - a)
    return out.clamp_(0, 255).to(torch.uint8)


def _luma(img: torch.Tensor) -> torch.Tensor:
    """Pillow's RGB → L: (19595 R + 38470 G + 7471 B + 2^15) >> 16, (H, W) uint8."""
    r, g, b = img.int().unbind(0)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).to(torch.uint8)


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """Pillow's RGB → HSV (libImaging/Convert.c ``rgb2hsv_row``), uint8 (3, H, W)."""
    rgb = img.int()
    r, g, b = rgb.unbind(0)
    maxc, minc = rgb.amax(0), rgb.amin(0)
    flat = maxc == minc
    cr = (maxc - minc).float().clamp_(min=1)
    s = cr / maxc.float().clamp_(min=1)
    rc, gc, bc = ((maxc - c).float() / cr for c in (r, g, b))
    rc, gc, bc = rc.double(), gc.double(), bc.double()  # C: double sums, float results
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.fmod(h.float().double() / 6.0 + 1.0, 1.0).float()
    uh = torch.where(flat, 0, (h.double() * 255.0).int().clamp(0, 255))
    us = torch.where(flat, 0, (s.double() * 255.0).int().clamp(0, 255))
    return torch.stack([uh, us, maxc]).to(torch.uint8)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Pillow's HSV → RGB (libImaging/Convert.c ``hsv2rgb``), uint8 (3, H, W)."""
    h, s, v = hsv.double().unbind(0)
    i = torch.floor(h.float().double() * 6.0 / 255.0)
    f = (h * 6.0 / 255.0 - i).float().double()
    fs = (s / 255.0).float().double()

    def rnd(x):  # C's round: half away from zero (the values are not negative)
        return torch.floor(x + 0.5).clamp(0, 255)

    p, q, t = rnd(v * (1.0 - fs)), rnd(v * (1.0 - fs * f)), rnd(v * (1.0 - fs * (1.0 - f)))
    sector = i.long() % 6
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = torch.zeros((3,) + h.shape, dtype=torch.float64)
    for k, chans in enumerate(table):
        sel = sector == k
        for c in range(3):
            out[c] = torch.where(sel, chans[c], out[c])
    out = torch.where(s == 0, v.expand(3, *v.shape), out)
    return out.to(torch.uint8)


@TRANSFORMATIONS_REGISTRY.register(name="photo_metric_distort", type="image_pil")
class PhotometricDistort(BaseTransformation):
    """Detection's photometric distortion: brightness (a blend with black),
    contrast (with the mean luma's gray, before or after the colour ops),
    saturation (with the image's luma), a hue shift by a fraction of the colour
    wheel in Pillow's 8-bit HSV, and a channel permutation, each with
    probability p, on uint8 (3, H, W) tensors. The arithmetic is Pillow's
    ``ImageEnhance`` and HSV conversion's, to within one level. The draws come
    from the producer thread's generator (``draw``); the JAX transform draws
    from the global numpy and ``random`` generators."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        prefix = "image_augmentation.photo_metric_distort."

        def bound(k, d):
            return getattr(opts, prefix + k, d) or d

        self.p = getattr(opts, prefix + "p", 0.5)
        self.contrast = (bound("alpha_min", 0.5), bound("alpha_max", 1.5))
        self.brightness = (bound("beta_min", 0.875), bound("beta_max", 1.125))
        self.saturation = (bound("gamma_min", 0.5), bound("gamma_max", 1.5))
        self.hue = (bound("delta_min", -0.05), bound("delta_max", 0.05))

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        prefix = "--image-augmentation.photo-metric-distort."
        group.add_argument(prefix + "enable", action="store_true", default=False)
        group.add_argument(prefix + "p", type=float, default=0.5)
        for name, default in (("alpha-min", 0.5), ("alpha-max", 1.5),
                              ("beta-min", 0.875), ("beta-max", 1.125),
                              ("gamma-min", 0.5), ("gamma-max", 1.5),
                              ("delta-min", -0.05), ("delta-max", 0.05)):
            group.add_argument(prefix + name, type=float, default=default)
        return parser

    def draw(self, rng, size_hw):
        """{op: factor} of the ops that run, in the JAX transform's order of
        draws (seven coin flips, then each op's factor)."""
        r = [rng.random() for _ in range(7)]
        params = {}
        if r[0] < self.p:
            params["brightness"] = rng.uniform(*self.brightness)
        contrast_before = r[1] < self.p
        if contrast_before and r[2] < self.p:
            params["contrast_before"] = rng.uniform(*self.contrast)
        if r[3] < self.p:
            params["saturation"] = rng.uniform(*self.saturation)
        if r[4] < self.p:
            params["hue"] = rng.uniform(*self.hue)
        if not contrast_before and r[5] < self.p:
            params["contrast_after"] = rng.uniform(*self.contrast)
        if r[6] < self.p:
            params["permutation"] = rng.sample(range(3), 3)
        return params, size_hw

    @staticmethod
    def _contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
        luma = _luma(img)
        mean = int(float(luma.double().mean()) + 0.5)
        return _blend(torch.full_like(img, mean), img, factor)

    def apply(self, data: Dict, params) -> Dict:
        img = data["image"]
        if "brightness" in params:
            img = _blend(torch.zeros_like(img), img, params["brightness"])
        if "contrast_before" in params:
            img = self._contrast(img, params["contrast_before"])
        if "saturation" in params:
            img = _blend(_luma(img).expand_as(img), img, params["saturation"])
        if "hue" in params:
            hsv = _rgb_to_hsv(img)
            shift = int(round(params["hue"] * 255.0))
            hsv[0] = ((hsv[0].int() + shift) % 256).to(torch.uint8)
            img = _hsv_to_rgb(hsv)
        if "contrast_after" in params:
            img = self._contrast(img, params["contrast_after"])
        if "permutation" in params:
            img = img[params["permutation"]]
        data["image"] = img.contiguous()
        return data


@TRANSFORMATIONS_REGISTRY.register(name="ssd_cropping", type="image_pil")
class SSDCroping(BaseTransformation):
    """The SSD paper's IoU-constrained random crop: draw a minimum IoU (or keep
    the image), then up to ``n_trials`` crops of 0.3-1 of each side within the
    aspect bounds whose IoU with every box meets it and that hold a box's
    center; keep those boxes, clipped and moved into the crop. The draws
    depend on the boxes, so ``draw_crop`` takes them (the dataset reads them
    from its annotation index in the producer thread) and returns the crop
    rectangle and the boxes kept; ``apply_crop`` does the work."""

    def __init__(self, opts, trials: int = None, **kwargs) -> None:
        super().__init__(opts)
        prefix = "image_augmentation.ssd_crop."
        self.trials = trials or getattr(opts, prefix + "n_trials", 40) or 40
        ious = getattr(opts, prefix + "iou_thresholds", None) or [
            0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0]
        self.iou_options = tuple(None if v >= 1.0 else float(v) for v in ious)
        self.min_aspect = getattr(opts, prefix + "min_aspect_ratio", 0.5) or 0.5
        self.max_aspect = getattr(opts, prefix + "max_aspect_ratio", 2.0) or 2.0

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        prefix = "--image-augmentation.ssd-crop."
        group.add_argument(prefix + "enable", action="store_true", default=False)
        group.add_argument(prefix + "iou-thresholds", type=float, nargs="+",
                           default=[0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0])
        group.add_argument(prefix + "n-trials", type=int, default=40)
        group.add_argument(prefix + "min-aspect-ratio", type=float, default=0.5)
        group.add_argument(prefix + "max-aspect-ratio", type=float, default=2.0)
        return parser

    @staticmethod
    def _iou(rect: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        lt = np.maximum(rect[:2], boxes[:, :2])
        rb = np.minimum(rect[2:], boxes[:, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        a_rect = (rect[2] - rect[0]) * (rect[3] - rect[1])
        a_box = np.prod(np.clip(boxes[:, 2:] - boxes[:, :2], 0, None), axis=1)
        return inter / np.maximum(a_rect + a_box - inter, 1e-8)

    def draw_crop(self, rng, size_hw: Tuple[int, int], boxes: np.ndarray):
        """(rect [x1, y1, x2, y2] float32 of integers, keep mask), or None to
        keep the image as it is (no boxes, or the "keep" option drawn)."""
        if boxes.shape[0] == 0:
            return None
        h, w = size_hw
        centers = (boxes[:, :2] + boxes[:, 2:]) / 2
        while True:
            min_iou = rng.choice(self.iou_options)
            if min_iou is None:
                return None
            for _ in range(self.trials):
                cw = rng.uniform(0.3, 1.0) * w
                ch = rng.uniform(0.3, 1.0) * h
                if not self.min_aspect < cw / ch < self.max_aspect:
                    continue
                left = rng.uniform(0, w - cw)
                top = rng.uniform(0, h - ch)
                rect = np.array([int(left), int(top), int(left + cw), int(top + ch)],
                                np.float32)
                if self._iou(rect, boxes).min() < min_iou:
                    continue
                keep = ((centers[:, 0] > rect[0]) & (centers[:, 0] < rect[2])
                        & (centers[:, 1] > rect[1]) & (centers[:, 1] < rect[3]))
                if keep.any():
                    return rect, keep

    @staticmethod
    def apply_crop(data: Dict, crop) -> Dict:
        if crop is None:
            return data
        rect, keep = crop
        kept = data["box_coordinates"][keep].copy()
        kept[:, :2] = np.maximum(kept[:, :2], rect[:2]) - rect[:2]
        kept[:, 2:] = np.minimum(kept[:, 2:], rect[2:]) - rect[:2]
        x1, y1, x2, y2 = (int(v) for v in rect)
        data["image"] = data["image"][:, y1:y2, x1:x2]
        data["box_coordinates"] = kept
        data["box_labels"] = data["box_labels"][keep]
        return data


# the segmentation transforms the port has not ported (no yaml of
# config/segmentation/ turns one on): the dest of each enable flag, and its class
# in the JAX package; a segmentation dataset asked for one raises
UNPORTED_SEGMENTATION_TRANSFORMS = {
    "image_augmentation.random_gaussian_noise.enable":
        "RandomGaussianBlur (cvnets_tpu/data/transforms/image_advanced.py:571)",
    "image_augmentation.random_rotate.enable":
        "RandomRotate (cvnets_tpu/data/transforms/image_advanced.py:445)",
    "image_augmentation.random_order.enable":
        "RandomOrder (cvnets_tpu/data/transforms/image_advanced.py:596)",
}


def arguments_unported_transforms(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group("Segmentation transforms not ported yet")
    for dest in UNPORTED_SEGMENTATION_TRANSFORMS:
        group.add_argument("--" + dest.replace("_", "-"), action="store_true", default=False)
    return parser


@TRANSFORMATIONS_REGISTRY.register(name="to_tensor", type="image_pil")
class ToFloatTensor(BaseTransformation):
    """Three channels of uint8 pixels: the [0, 1] division and, under
    ``--image-augmentation.to-tensor.mean-std-normalization.enable``, the
    per-channel mean/std normalization run on the card in the train and eval
    steps (``engine.train_state.UnitNormalizer``; the JAX package's Pillow path
    does both here, its native-loader path divides on the device)."""

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        prefix = "--image-augmentation.to-tensor.mean-std-normalization."
        group.add_argument(prefix + "enable", action="store_true", default=False)
        group.add_argument(prefix + "mean", type=float, nargs="+", default=None)
        group.add_argument(prefix + "std", type=float, nargs="+", default=None)
        return parser

    def apply(self, data: Dict, params) -> Dict:
        img = data["image"]
        if img.shape[0] == 1:
            img = img.expand(3, -1, -1)
        data["image"] = img.contiguous()
        return data
