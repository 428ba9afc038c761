"""The plain version of the native decoder: Pillow's decode and torch ops that
take the steps of ``csrc/jpeg_decode.cu``'s crop → resize → flip kernel, which
follows the JAX package's ``cvnets_tpu/native/decode.cpp`` (``decode_one``,
``resize_area``, ``resize_bilinear``):

1. the crop ``(x, y, w, h)`` in the original image's coordinates (``w <= 0``:
   the whole image) clamped to the image (decode.cpp:138-147);
2. the prescale: the coarsest 1/2^k raster (k ≤ 3) whose crop still covers the
   output (decode.cpp:151-155). decode.cpp asks libjpeg's scaled IDCT for it;
   nvJPEG has none, so here and in the kernel a prescaled pixel is the
   ``denom × denom`` box mean of the full raster (the valid part of a box at
   the right and bottom edges), rounded half up in integers. This is where the
   port parts from the JAX package by design;
3. the crop in the prescaled raster by integer division (decode.cpp:161-168);
4. area averaging where the crop is at least 1.5× the output on both sides,
   bilinear otherwise (decode.cpp:201), with ``resize_area``'s and
   ``resize_bilinear``'s float32 arithmetic, each operation rounded on its own
   (no fused multiply-add), and the ``+ 0.5`` truncation to uint8;
5. the mirror written while storing (``ox = out_w - 1 - x``).

The crop of the prescaled raster, its box means and the area sums are integer
arithmetic (exact); the float32 steps are single torch ops in the order of
decode.cpp's expressions, so the kernel (which spells each one as an ``_rn``
intrinsic) and this version give the same bits from the same raster.

Pillow is imported inside the decoder only. An image Pillow cannot decode, and
a CMYK one (libjpeg's ``JCS_RGB`` conversion refuses CMYK, so decode.cpp
fails it), fails: status 0 and zeros. Grayscale is read as RGB.
"""

from __future__ import annotations

import io
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Crop = Tuple[int, int, int, int]


def decode_rgb(blob: bytes) -> Optional[np.ndarray]:
    """The JPEG's pixels as RGB, HWC uint8, or None where decode.cpp's libjpeg
    call would fail (unreadable, truncated, CMYK)."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(blob)) as img:
            if img.mode == "CMYK":
                return None
            return np.array(img.convert("RGB"))
    except Exception:  # Pillow raises many types for a damaged file
        return None


def jpeg_size(blob: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the header, or None."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(blob)) as img:
            return img.width, img.height
    except Exception:
        return None


def crop_plan(width: int, height: int, crop: Crop, out_hw: Tuple[int, int]
              ) -> Tuple[int, int, int, int, int, bool]:
    """(denom, x, y, w, h, area) for an image of ``width × height``: the
    prescale, the crop in the prescaled raster and whether the area rule
    applies (decode.cpp:138-172, 201)."""
    out_h, out_w = out_hw
    cx, cy, cw, ch = (int(v) for v in crop)
    if cw <= 0 or ch <= 0:
        cx, cy, cw, ch = 0, 0, width, height
    cx = max(0, min(cx, width - 1))
    cy = max(0, min(cy, height - 1))
    cw = max(1, min(cw, width - cx))
    ch = max(1, min(ch, height - cy))
    denom = 1
    while denom < 8 and cw // (denom * 2) >= out_w and ch // (denom * 2) >= out_h:
        denom *= 2
    dec_w, dec_h = -(-width // denom), -(-height // denom)  # libjpeg rounds up
    dcx, dcy = min(cx // denom, dec_w - 1), min(cy // denom, dec_h - 1)
    dcw = min(max(1, cw // denom), dec_w - dcx)
    dch = min(max(1, ch // denom), dec_h - dcy)
    area = dcw >= out_w * 3 // 2 and dch >= out_h * 3 // 2
    return denom, dcx, dcy, dcw, dch, area


def _prescaled_crop(raster: torch.Tensor, denom: int, x: int, y: int, w: int, h: int
                    ) -> torch.Tensor:
    """(h, w, 3) int64: the crop of the raster prescaled by ``denom``, each pixel
    the rounded mean of its box's valid pixels."""
    rows = raster[y * denom:(y + h) * denom, x * denom:(x + w) * denom].to(torch.int64)
    if denom == 1:
        return rows
    pad_h, pad_w = h * denom - rows.shape[0], w * denom - rows.shape[1]
    ones = torch.ones(rows.shape[:2], dtype=torch.int64, device=raster.device)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, pad_w, 0, pad_h))
    ones = torch.nn.functional.pad(ones, (0, pad_w, 0, pad_h))
    total = rows.view(h, denom, w, denom, 3).sum(dim=(1, 3))
    count = ones.view(h, denom, w, denom).sum(dim=(1, 3)).unsqueeze(-1)
    return torch.div(total + count // 2, count, rounding_mode="floor")


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _to_uint8(v: torch.Tensor) -> torch.Tensor:
    """``static_cast<uint8_t>`` of a float in [0, 256): truncation."""
    return v.to(torch.int32).to(torch.uint8)


def _resize_area(src: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """decode.cpp's ``resize_area`` of (sh, sw, 3) int64 to (out_h, out_w, 3)."""
    sh, sw, dev = src.shape[0], src.shape[1], src.device

    def bounds(n_out: int, n_in: int):
        scale = _f32(n_in, dev) / _f32(n_out, dev)
        pos = torch.arange(n_out + 1, dtype=torch.float32, device=dev)
        lo, hi = (pos[:-1] * scale).to(torch.int64), (pos[1:] * scale).to(torch.int64)
        hi = torch.where(hi <= lo, lo + 1, hi).clamp(max=n_in)
        return lo, hi

    y0, y1 = bounds(out_h, sh)
    x0, x1 = bounds(out_w, sw)
    table = torch.nn.functional.pad(src.cumsum(0).cumsum(1), (0, 0, 1, 0, 1, 0))
    acc = (table[y1][:, x1] - table[y0][:, x1] - table[y1][:, x0] + table[y0][:, x0])
    count = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).to(torch.float32)
    inv = _f32(1.0, dev) / count
    return _to_uint8(acc.to(torch.float32) * inv.unsqueeze(-1) + 0.5)


def _bilinear_taps(n_out: int, n_in: int, dev):
    scale = _f32(n_in, dev) / _f32(n_out, dev)
    c = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * scale - 0.5
    c = torch.clamp(c, min=0.0).minimum(_f32(n_in - 1, dev))
    lo = c.to(torch.int64)
    return lo, torch.clamp(lo + 1, max=n_in - 1), c - lo.to(torch.float32)


def _resize_bilinear(src: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """decode.cpp's ``resize_bilinear`` of (sh, sw, 3) int64 to (out_h, out_w, 3)."""
    dev = src.device
    y0, y1, fy = _bilinear_taps(out_h, src.shape[0], dev)
    x0, x1, fx = _bilinear_taps(out_w, src.shape[1], dev)
    fx = fx[None, :, None]
    r0, r1 = src[y0].to(torch.float32), src[y1].to(torch.float32)
    top = r0[:, x0] + (r0[:, x1] - r0[:, x0]) * fx
    bot = r1[:, x0] + (r1[:, x1] - r1[:, x0]) * fx
    return _to_uint8(top + (bot - top) * fy[:, None, None] + 0.5)


def crop_resize_flip(raster: torch.Tensor, crop: Crop, flip: bool,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """(3, out_h, out_w) uint8 from one decoded (H, W, 3) uint8 raster, on the
    raster's device: the kernel's function for one image."""
    height, width = raster.shape[:2]
    denom, x, y, w, h, area = crop_plan(width, height, crop, out_hw)
    src = _prescaled_crop(raster, denom, x, y, w, h)
    out = (_resize_area if area else _resize_bilinear)(src, *out_hw)
    if flip:
        out = out.flip(1)
    return out.permute(2, 0, 1).contiguous()


def decode_rrc_batch_plain(blobs: Sequence[bytes], crops: Sequence[Crop],
                           flips: Optional[Sequence[bool]], out_hw: Tuple[int, int]
                           ) -> Tuple[torch.Tensor, np.ndarray]:
    """(uint8 (B, 3, H, W) CPU tensor, bool (B,) status): every JPEG decoded by
    Pillow and taken through ``crop_resize_flip``; a failed one is zeros."""
    out = torch.zeros((len(blobs), 3, *out_hw), dtype=torch.uint8)
    status = np.zeros(len(blobs), dtype=bool)
    for i, blob in enumerate(blobs):
        rgb = decode_rgb(blob)
        if rgb is None:
            continue
        out[i] = crop_resize_flip(torch.from_numpy(rgb), crops[i],
                                  bool(flips[i]) if flips is not None else False, out_hw)
        status[i] = True
    return out, status


def dimensions_plain(blobs: Sequence[bytes]) -> List[Tuple[int, int]]:
    """(width, height) of each header, (0, 0) where it cannot be read."""
    return [jpeg_size(b) or (0, 0) for b in blobs]
