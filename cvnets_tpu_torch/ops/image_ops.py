"""Batched augmentation on the device: the 14 ops of RandAugment, RandAugment,
TrivialAugmentWide and random erasing (counterpart of cvnets_tpu/ops/image_ops.py).

Images are NCHW float batches in [0, 1] on their device; none of these ops is a
TPU kernel, so all of them are plain torch. Each op takes per-image factors,
(n,) tensors or floats, with the JAX op's formula and order of operations (the
sharpness blur and the grayscale are written as sums, so no TF32 product
reaches them on a card).

The random parameters are drawn on the host from a ``np.random.Generator`` (the
train step seeds one with (seed, step, stream)): the op of each image, its
magnitude and sign, the erasing boxes. The host groups the images by the op
they drew, one gather puts each group in a contiguous slice, each op runs once
on its slice, and one gather at the end restores the order: each image's pixels
are read and written once a round, however many ops the batch holds. Host
arrays reach the card by ``non_blocking`` copies from pinned memory, so nothing
here waits for the device. The erasing noise is drawn on the device from a
generator seeded by the host's draw.
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

N_OPS = 14  # identity, shear x/y, translate x/y, rotate, brightness, saturation,
# contrast, sharpness, posterize, solarize, autocontrast, equalize


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host wait: pinned, then copied with
    ``non_blocking`` on a CUDA device."""
    t = torch.as_tensor(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _per_image(v, img: torch.Tensor) -> torch.Tensor:
    """A float or an (n,) tensor as an (n, 1, 1, 1) factor of ``img``'s dtype."""
    if not isinstance(v, torch.Tensor):
        return torch.tensor(float(v), dtype=img.dtype, device=img.device)
    return v.to(img.dtype).view(-1, 1, 1, 1)


# --------------------------------------------------------------------- helpers


def _blend(a: torch.Tensor, b, factor) -> torch.Tensor:
    return (b + _per_image(factor, a) * (a - b)).clamp(0.0, 1.0)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """(n, 1, h, w): 0.299 r + 0.587 g + 0.114 b."""
    return 0.299 * img[:, 0:1] + 0.587 * img[:, 1:2] + 0.114 * img[:, 2:3]


# --------------------------------------------------------------- photometric


def adjust_brightness(img, factor):
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img, factor):
    return _blend(img, _grayscale(img).mean(dim=(1, 2, 3), keepdim=True), factor)


def adjust_saturation(img, factor):
    return _blend(img, _grayscale(img), factor)


def adjust_sharpness(img, factor):
    """Blend with Pillow's 3×3 SMOOTH filter ([[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13),
    which leaves the 1-pixel border as it is."""
    h, w = img.shape[-2:]
    s = 4 * img[..., 1:-1, 1:-1]  # the centre's weight 5: once more in the 3×3 sum
    for dy in range(3):
        for dx in range(3):
            s = s + img[..., dy:dy + h - 2, dx:dx + w - 2]
    blurred = img.clone()
    blurred[..., 1:-1, 1:-1] = s / 13.0
    return _blend(img, blurred, factor)


def posterize(img, bits):
    """Keep the top ``bits`` bits of the 8-bit value (``bits`` may be fractional,
    as RandAugment's magnitudes make it)."""
    q = torch.pow(2.0, 8.0 - _per_image(bits, img))
    v = (img * 255.0).clamp(0.0, 255.0)
    return torch.floor(v / q) * q / 255.0


def solarize(img, threshold):
    return torch.where(img >= _per_image(threshold, img), 1.0 - img, img)


def invert(img):
    return 1.0 - img


def autocontrast(img):
    lo = img.amin(dim=(-2, -1), keepdim=True)
    hi = img.amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / torch.clamp(hi - lo, min=1e-6), torch.ones_like(hi))
    return ((img - lo) * scale).clamp(0.0, 1.0)


def equalize(img):
    """Per-channel histogram equalization of each image: the float statement of
    Pillow's integer LUT (``step = (npixels - hist[last nonzero]) // 255``,
    ``lut[i] = (step // 2 + cumsum(hist[:i])) // step``, the identity when
    ``step`` is 0 or at most one bin is used), as the JAX op; counts are
    integers, exact in float32."""
    n, c, h, w = img.shape
    v = torch.round(img * 255.0).clamp(0, 255).to(torch.int64).view(n * c, h * w)
    hist = torch.zeros((n * c, 256), dtype=torch.float32, device=img.device)
    hist.scatter_add_(1, v, torch.ones_like(v, dtype=torch.float32))
    bins = torch.arange(256, device=img.device)
    nonzero = hist > 0
    last_nz = torch.where(nonzero, bins, 0).amax(dim=1, keepdim=True)
    step = torch.floor((hist.sum(dim=1, keepdim=True) - hist.gather(1, last_nz)) / 255.0)
    cum_excl = hist.cumsum(dim=1) - hist
    lut = torch.floor((torch.floor(step / 2.0) + cum_excl) / torch.clamp(step, min=1.0))
    lut = lut.clamp(0.0, 255.0)
    identity = (step <= 0) | (nonzero.sum(dim=1, keepdim=True) <= 1)
    lut = torch.where(identity, bins.to(torch.float32), lut)
    return (lut.gather(1, v) / 255.0).view(n, c, h, w).to(img.dtype)


# ---------------------------------------------------------------- geometric


def _affine_sample(img: torch.Tensor, m: List[torch.Tensor], fill: float = 0.5
                   ) -> torch.Tensor:
    """Bilinear samples of ``img`` at the inverse affine map ``m`` (six (n,)
    tensors, row-major 2×3) of each output pixel, in coordinates centered on the
    image; each corner outside the image counts as ``fill``. Sampling
    ``img - fill`` with zero padding and adding ``fill`` back gives that exactly
    (the corner weights sum to 1); ``align_corners=True`` puts -1 and 1 on the
    centres of the first and last pixels."""
    n, c, h, w = img.shape
    ys = torch.arange(h, dtype=torch.float32, device=img.device) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=img.device) - (w - 1) / 2.0
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    m = [t.to(torch.float32).view(-1, 1, 1) for t in m]
    src_x = m[0] * xx + m[1] * yy + m[2] + (w - 1) / 2.0
    src_y = m[3] * xx + m[4] * yy + m[5] + (h - 1) / 2.0
    grid = torch.stack((src_x * (2.0 / (w - 1)) - 1.0, src_y * (2.0 / (h - 1)) - 1.0), dim=-1)
    out = F.grid_sample(img - fill, grid.expand(n, h, w, 2).to(img.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out + fill


def _vec(v, img) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).reshape(-1).expand(img.shape[0])
    return torch.full((img.shape[0],), float(v), dtype=torch.float32, device=img.device)


def rotate(img, degrees, fill: float = 0.5):
    rad = _vec(degrees, img) * math.pi / 180.0
    cos, sin, zero = torch.cos(rad), torch.sin(rad), torch.zeros_like(rad)
    return _affine_sample(img, [cos, -sin, zero, sin, cos, zero], fill)


def shear_x(img, mag, fill: float = 0.5):
    mag = _vec(mag, img)
    one, zero = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine_sample(img, [one, mag, zero, zero, one, zero], fill)


def shear_y(img, mag, fill: float = 0.5):
    mag = _vec(mag, img)
    one, zero = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine_sample(img, [one, zero, zero, mag, one, zero], fill)


def translate_x(img, pixels, fill: float = 0.5):
    pixels = _vec(pixels, img)
    one, zero = torch.ones_like(pixels), torch.zeros_like(pixels)
    return _affine_sample(img, [one, zero, pixels, zero, one, zero], fill)


def translate_y(img, pixels, fill: float = 0.5):
    pixels = _vec(pixels, img)
    one, zero = torch.ones_like(pixels), torch.zeros_like(pixels)
    return _affine_sample(img, [one, zero, zero, zero, one, pixels], fill)


# -------------------------------------------------------------- RandAugment


def randaug_op(img: torch.Tensor, op_idx: int, mag, sign) -> torch.Tensor:
    """Op ``op_idx`` of the table at magnitude fraction ``mag``, negated where
    ``sign`` ≤ 0.5 (floats or (n,) tensors); the JAX ``_randaug_apply`` on a
    batch whose images all drew this op. The magnitudes map as torchvision's
    RandAugment does."""
    h, w = img.shape[-2:]
    mag, sign = _vec(mag, img), _vec(sign, img)
    signed = torch.where(sign > 0.5, mag, -mag)
    if op_idx == 0:
        return img
    if op_idx == 1:
        return shear_x(img, signed * 0.3)
    if op_idx == 2:
        return shear_y(img, signed * 0.3)
    if op_idx == 3:
        return translate_x(img, signed * 150.0 / 331.0 * w)
    if op_idx == 4:
        return translate_y(img, signed * 150.0 / 331.0 * h)
    if op_idx == 5:
        return rotate(img, signed * 30.0)
    if op_idx == 6:
        return adjust_brightness(img, 1.0 + signed * 0.9)
    if op_idx == 7:
        return adjust_saturation(img, 1.0 + signed * 0.9)
    if op_idx == 8:
        return adjust_contrast(img, 1.0 + signed * 0.9)
    if op_idx == 9:
        return adjust_sharpness(img, 1.0 + signed * 0.9)
    if op_idx == 10:
        return posterize(img, 8.0 - mag * 4.0)
    if op_idx == 11:
        return solarize(img, 1.0 - mag)
    if op_idx == 12:
        return autocontrast(img)
    if op_idx == 13:
        return equalize(img)
    raise ValueError(f"RandAugment op {op_idx} is not one of the {N_OPS}")


def apply_randaug_ops(images: torch.Tensor, op_idx: np.ndarray, mag: np.ndarray,
                      sign: np.ndarray) -> torch.Tensor:
    """Round k applies op ``op_idx[i, k]`` at ``mag[i, k]``, ``sign[i, k]`` to image
    i, for every image and round (host arrays of shape (n, rounds)). Each round
    gathers the images into groups by op and runs each op once on its group."""
    op_idx = np.asarray(op_idx, np.int64)
    mag, sign = np.asarray(mag, np.float32), np.asarray(sign, np.float32)
    n, rounds = op_idx.shape
    if not op_idx.any():
        return images  # every image drew the identity in every round
    pos = np.arange(n)  # the original index of the image at each position
    orders, counts, host_f = [], [], np.empty((2, rounds, n), np.float32)
    for k in range(rounds):
        order = np.argsort(op_idx[pos, k], kind="stable")
        pos = pos[order]
        orders.append(order)
        counts.append(np.bincount(op_idx[pos, k], minlength=N_OPS).tolist())
        host_f[0, k], host_f[1, k] = mag[pos, k], sign[pos, k]
    dev_i = to_device(np.stack(orders + [np.argsort(pos)]), images.device)
    dev_f = to_device(host_f, images.device)
    x = images
    for k in range(rounds):
        x = x.index_select(0, dev_i[k])
        start = 0
        for op, cnt in enumerate(counts[k]):
            if cnt and op:
                end = start + cnt
                x[start:end] = randaug_op(x[start:end], op, dev_f[0, k, start:end],
                                          dev_f[1, k, start:end])
            start += cnt
    return x.index_select(0, dev_i[rounds])


def rand_augment(images: torch.Tensor, rng: np.random.Generator, num_ops: int = 2,
                 magnitude: int = 9, num_magnitude_bins: int = 31) -> torch.Tensor:
    """Each image draws ``num_ops`` ops at magnitude ``magnitude / (bins - 1)``,
    each with a random sign."""
    n = images.shape[0]
    op_idx = rng.integers(0, N_OPS, (n, num_ops))
    sign = rng.random((n, num_ops), dtype=np.float32)
    mag = np.full((n, num_ops), magnitude / (num_magnitude_bins - 1), np.float32)
    return apply_randaug_ops(images, op_idx, mag, sign)


def trivial_augment_wide(images: torch.Tensor, rng: np.random.Generator,
                         num_magnitude_bins: int = 31) -> torch.Tensor:
    """Each image draws one op at a uniform magnitude fraction with a random sign."""
    n = images.shape[0]
    op_idx = rng.integers(0, N_OPS, (n, 1))
    mag = rng.random((n, 1), dtype=np.float32)
    sign = rng.random((n, 1), dtype=np.float32)
    return apply_randaug_ops(images, op_idx, mag, sign)


# ----------------------------------------------------------- random erasing


def erasing_boxes(h: int, w: int, area_frac: np.ndarray, log_ratio: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(box height, box width) of each image, in float32 as the JAX op: the area
    ``h·w·area_frac`` at aspect ``exp(log_ratio)``, each side clipped to
    [1, side − 1] and truncated."""
    area = np.float32(h * w) * np.asarray(area_frac, np.float32)
    r = np.exp(np.asarray(log_ratio, np.float32))
    eh = np.clip(np.sqrt(area * r), np.float32(1), np.float32(h - 1)).astype(np.int32)
    ew = np.clip(np.sqrt(area / r), np.float32(1), np.float32(w - 1)).astype(np.int32)
    return eh, ew


def apply_random_erasing(images: torch.Tensor, apply: np.ndarray, area_frac: np.ndarray,
                         log_ratio: np.ndarray, top: np.ndarray, left: np.ndarray,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Each image i with ``apply[i]`` gets the rows [top, top + eh) and columns
    [left, left + ew) (cut at the image's edge) replaced by standard normal
    noise: ``noise`` (one image a selected image, in order) or drawn with
    ``generator``."""
    n, c, h, w = images.shape
    chosen = np.flatnonzero(np.asarray(apply))
    if chosen.size == 0:
        return images
    eh, ew = erasing_boxes(h, w, np.asarray(area_frac)[chosen], np.asarray(log_ratio)[chosen])
    top, left = np.asarray(top)[chosen], np.asarray(left)[chosen]
    dev = to_device(np.stack([chosen, top, top + eh, left, left + ew]).astype(np.int64),
                    images.device)
    sub = images.index_select(0, dev[0])
    rows = torch.arange(h, device=images.device).view(1, h, 1)
    cols = torch.arange(w, device=images.device).view(1, 1, w)
    box = ((rows >= dev[1].view(-1, 1, 1)) & (rows < dev[2].view(-1, 1, 1))
           & (cols >= dev[3].view(-1, 1, 1)) & (cols < dev[4].view(-1, 1, 1)))
    if noise is None:
        noise = torch.randn(sub.shape, generator=generator, device=images.device,
                            dtype=images.dtype)
    sub = torch.where(box.unsqueeze(1), noise.to(images.dtype), sub)
    return images.index_copy(0, dev[0], sub)


def random_erasing(images: torch.Tensor, rng: np.random.Generator, p: float = 0.25,
                   scale: Tuple[float, float] = (0.02, 0.33),
                   ratio: Tuple[float, float] = (0.3, 3.3)) -> torch.Tensor:
    """Each image is erased with probability ``p`` by a box of area fraction
    uniform in ``scale`` and log-aspect uniform in log ``ratio``, at a uniform
    top-left corner, filled with standard normal noise."""
    n, _, h, w = images.shape
    apply = rng.random(n) < p
    area_frac = rng.uniform(scale[0], scale[1], n).astype(np.float32)
    log_ratio = rng.uniform(math.log(ratio[0]), math.log(ratio[1]), n).astype(np.float32)
    top, left = rng.integers(0, h, n), rng.integers(0, w, n)
    generator = torch.Generator(images.device).manual_seed(int(rng.integers(2**62)))
    return apply_random_erasing(images, apply, area_frac, log_ratio, top, left,
                                generator=generator)


# ----------------------------------------------------------------- pipeline


def build_device_augmenter(opts) -> Optional[Callable]:
    """The enabled device-tier augmentations as one ``fn(images, rng)``, in the
    JAX package's order (RandAugment, TrivialAugmentWide, random erasing);
    None when none is enabled. The train step runs it before mixup / cutmix."""
    steps = []
    if getattr(opts, "image_augmentation.rand_augment.enable", False):
        m = getattr(opts, "image_augmentation.rand_augment.magnitude", None)
        if m is None:
            m = getattr(opts, "image_augmentation.rand_augment.m", None)
        m = 9 if m is None else int(m)
        n = getattr(opts, "image_augmentation.rand_augment.num_ops", None)
        if n is None:
            n = getattr(opts, "image_augmentation.rand_augment.n", None)
        n = 2 if n is None else int(n)
        bins = int(getattr(opts, "image_augmentation.rand_augment.num_magnitude_bins", None)
                   or 31)
        steps.append(lambda x, rng: rand_augment(x, rng, num_ops=n, magnitude=m,
                                                 num_magnitude_bins=bins))
    if getattr(opts, "image_augmentation.trivial_augment_wide.enable", False):
        steps.append(trivial_augment_wide)
    if getattr(opts, "image_augmentation.random_erase.enable", False):
        p = getattr(opts, "image_augmentation.random_erase.p", 0.25) or 0.25
        steps.append(lambda x, rng: random_erasing(x, rng, p=p))
    if not steps:
        return None

    def augment(images: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        for step in steps:
            images = step(images, rng)
        return images

    return augment


def arguments_device_augmentation(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Device-tier augmentation")
    group.add_argument("--image-augmentation.rand-augment.enable", action="store_true",
                       default=False)
    group.add_argument("--image-augmentation.rand-augment.n", type=int, default=None)
    group.add_argument("--image-augmentation.rand-augment.m", type=int, default=None)
    group.add_argument("--image-augmentation.rand-augment.p", type=float, default=1.0)
    group.add_argument("--image-augmentation.rand-augment.num-ops", type=int, default=None)
    group.add_argument("--image-augmentation.rand-augment.magnitude", type=int, default=None)
    group.add_argument("--image-augmentation.rand-augment.num-magnitude-bins", type=int,
                       default=None)
    group.add_argument("--image-augmentation.rand-augment.interpolation", type=str,
                       default="bilinear",
                       help="Geometric-op resampling; the device tier implements bilinear")
    group.add_argument("--image-augmentation.trivial-augment-wide.num-magnitude-bins",
                       type=int, default=None)
    group.add_argument("--image-augmentation.trivial-augment-wide.interpolation", type=str,
                       default="bilinear")
    group.add_argument("--image-augmentation.trivial-augment-wide.enable",
                       action="store_true", default=False)
    group.add_argument("--image-augmentation.random-erase.enable", action="store_true",
                       default=False)
    group.add_argument("--image-augmentation.random-erase.p", type=float, default=0.5)
    # host-tier policies of the JAX package (on Pillow), refused by the dataset
    group.add_argument("--image-augmentation.auto-augment.enable", action="store_true",
                       default=False)
    group.add_argument("--image-augmentation.rand-augment.use-timm-library",
                       action="store_true", default=False)
    return parser
