"""Byte-domain transforms of ByteFormer (counterpart of
cvnets_tpu/data/transforms/image_bytes.py): ``pil_save``, ``shuffle_bytes``,
``byte_permutation``, ``mask_positions`` and ``random_uniform``.

Each works on ``{"image": array}``, a sample's pixels (HWC) or a flat buffer of
byte values. The random ones split the draw from the work, as the port's host
transforms do: ``draw(rng, n)`` takes the parameters for a buffer of ``n``
values from ``rng`` and ``apply(data, params)`` uses them. ``rng`` is the
loader's per-epoch ``random.Random`` (the collate runs in the loader's
producer thread, so the draws come in sample order), from which a numpy
generator is seeded for the bulk draw; a ``np.random.RandomState`` is taken
as it is, which makes the draws the JAX transforms make from ``np.random``
after ``np.random.seed`` on that state's seed. The fixed patterns (the window
shuffle, the byte permutation, the kept positions) come from the JAX
package's fixed seed.
"""

from __future__ import annotations

import argparse
import io
import random
from typing import Dict, Optional, Union

import numpy as np

from cvnets_tpu_torch.data.transforms import TRANSFORMATIONS_REGISTRY
from cvnets_tpu_torch.data.transforms.common import BaseTransformation

_FIXED_SEED = 2147483647  # image_bytes.py:17-19
Rng = Union[random.Random, np.random.RandomState]


def numpy_draws(rng: Optional[Rng]) -> np.random.RandomState | np.random.Generator:
    """The numpy generator of one draw: ``rng`` itself if it is a
    ``RandomState``, else a generator seeded from the ``random.Random``."""
    if rng is None:
        raise ValueError("this transform draws from the loader's generator: pass rng")
    if isinstance(rng, np.random.RandomState):
        return rng
    return np.random.default_rng(rng.getrandbits(64))


def _integers(gen, low: int, high: int, size) -> np.ndarray:
    """Integers in [low, high) from a ``RandomState`` or a ``Generator``."""
    if isinstance(gen, np.random.RandomState):
        return gen.randint(low, high, size)
    return gen.integers(low, high, size)


def to_uint8_pil(img):
    """cvnets_tpu/data/transforms/image.py ``_to_pil``: a uint8 array as it
    is, any other as its [0, 1] values × 255, truncated."""
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return Image.fromarray(arr)


class ByteTransform(BaseTransformation):
    """A transform of a buffer of ``n`` values; no random draw unless it says."""

    def draw(self, rng: Optional[Rng], n: int):
        return None


@TRANSFORMATIONS_REGISTRY.register(name="pil_save", type="image_bytes")
class PILSave(ByteTransform):
    """The image encoded to file bytes (image_bytes.py:22-87): JPEG at
    ``quality``, PNG at compress level 0, TIFF, or the raw uint8 pixels
    channel-first (``fCHW``) or channel-last (``fHWC``). ``file-encoding``
    wins over ``encoding``."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.file_encoding = (
            getattr(opts, "image_augmentation.pil_save.file_encoding", None)
            or getattr(opts, "image_augmentation.pil_save.encoding", "jpeg") or "jpeg")
        self.quality = getattr(opts, "image_augmentation.pil_save.quality", 100)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--image-augmentation.pil-save.enable",
                           action="store_true", default=False)
        group.add_argument("--image-augmentation.pil-save.file-encoding", type=str,
                           default=None,
                           help="Reference flag name; wins over "
                                "--image-augmentation.pil-save.encoding")
        group.add_argument("--image-augmentation.pil-save.encoding", type=str,
                           default="jpeg",
                           choices=["jpeg", "png", "tiff", "fcam",
                                    "fCHW", "fHWC", "JPEG", "PNG", "TIFF"])
        group.add_argument("--image-augmentation.pil-save.quality", type=int,
                           default=100)
        return parser

    def apply(self, data: Dict, params=None) -> Dict:
        img = to_uint8_pil(data["image"])
        fmt = self.file_encoding.upper()
        if fmt in ("FCHW", "FHWC"):
            arr = np.asarray(img, np.uint8)
            if fmt == "FCHW":
                arr = arr.transpose(2, 0, 1)
            data["image"] = arr.reshape(-1).astype(np.int32)
            return data
        buf = io.BytesIO()
        if fmt == "JPEG":
            img.save(buf, format="JPEG", quality=self.quality)
        elif fmt == "PNG":
            img.save(buf, format="PNG", compress_level=0)
        else:
            img.save(buf, format=fmt)
        data["image"] = np.frombuffer(buf.getvalue(), np.uint8).astype(np.int32)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="shuffle_bytes", type="image_bytes")
class ShuffleBytes(ByteTransform):
    """A buffer reordered (image_bytes.py:90-164): ``reverse``,
    ``random_shuffle`` (a permutation drawn a sample), ``cyclic_half_length``
    (rolled by N/2), ``stride`` (positions interleaved at the stride) or
    ``window_shuffle`` (one fixed permutation of every whole window, the tail
    left as it is)."""

    MODES = ("reverse", "random_shuffle", "cyclic_half_length", "stride",
             "window_shuffle")

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.mode = getattr(opts, "image_augmentation.shuffle_bytes.mode",
                            "reverse") or "reverse"
        self.stride = getattr(opts, "image_augmentation.shuffle_bytes.stride", 1024)
        window_size = getattr(opts, "image_augmentation.shuffle_bytes.window_size", 1024)
        self.window_shuffle = np.random.default_rng(_FIXED_SEED).permutation(window_size)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--image-augmentation.shuffle-bytes.enable",
                           action="store_true", default=False)
        group.add_argument("--image-augmentation.shuffle-bytes.mode", type=str,
                           default="reverse", choices=list(cls.MODES))
        group.add_argument("--image-augmentation.shuffle-bytes.stride",
                           type=int, default=1024)
        group.add_argument("--image-augmentation.shuffle-bytes.window-size",
                           type=int, default=1024)
        return parser

    def draw(self, rng: Optional[Rng], n: int):
        """The permutation of ``random_shuffle``; nothing for the other modes."""
        return numpy_draws(rng).permutation(n) if self.mode == "random_shuffle" else None

    def apply(self, data: Dict, params=None) -> Dict:
        x = np.asarray(data["image"]).reshape(-1)
        n = x.shape[0]
        if self.mode == "reverse":
            x = x[::-1]
        elif self.mode == "random_shuffle":
            x = x[params]
        elif self.mode == "cyclic_half_length":
            x = np.roll(x, n // 2)
        elif self.mode == "stride":
            x = np.concatenate([x[i::self.stride] for i in range(self.stride)])
        elif self.mode == "window_shuffle":
            w = self.window_shuffle.shape[0]
            num_windows = n // w
            if num_windows:
                head = x[: num_windows * w].reshape(num_windows, w)
                x = np.concatenate([head[:, self.window_shuffle].reshape(-1),
                                    x[num_windows * w:]])
        else:
            raise NotImplementedError(
                f"shuffle_bytes mode={self.mode}; expected one of {self.MODES}")
        data["image"] = np.ascontiguousarray(x)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="byte_permutation", type="image_bytes")
class BytePermutation(ByteTransform):
    """Every byte value mapped through one fixed permutation of [0, 256);
    negative values (padding) kept (image_bytes.py:167-189)."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.mapping = np.random.default_rng(_FIXED_SEED).permutation(256)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--image-augmentation.byte-permutation.enable",
                           action="store_true", default=False)
        return parser

    def apply(self, data: Dict, params=None) -> Dict:
        arr = np.asarray(data["image"]).astype(np.int64)
        valid = arr >= 0
        out = arr.copy()
        out[valid] = self.mapping[arr[valid] % 256]
        data["image"] = out.astype(np.int32)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="mask_positions", type="image_bytes")
class MaskPositions(ByteTransform):
    """The ``keep_frac`` of a buffer's positions chosen once a length from the
    fixed seed, the rest dropped (image_bytes.py:192-232)."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.keep_frac = getattr(opts, "image_augmentation.mask_positions.keep_frac", 0.25)
        self._cached_mask = None

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--image-augmentation.mask-positions.enable",
                           action="store_true", default=False)
        group.add_argument("--image-augmentation.mask-positions.keep-frac",
                           type=float, default=0.25)
        return parser

    def _mask_for(self, n: int) -> np.ndarray:
        mask = self._cached_mask  # one read: the loader's threads may share the transform
        if mask is None or mask.shape[0] != n:
            rng = np.random.default_rng(_FIXED_SEED)
            mask = np.zeros(n, dtype=bool)
            mask[rng.permutation(n)[: int(self.keep_frac * n)]] = True
            self._cached_mask = mask
        return mask

    def apply(self, data: Dict, params=None) -> Dict:
        x = np.asarray(data["image"]).reshape(-1)
        data["image"] = np.ascontiguousarray(x[self._mask_for(x.shape[0])])
        return data


@TRANSFORMATIONS_REGISTRY.register(name="random_uniform", type="image_bytes")
class RandomUniformNoise(ByteTransform):
    """Integer noise drawn uniformly from ``width_range`` (both ends included)
    added to every value that is not padding, mod 256
    (image_bytes.py:235-262). The values are cast to int32 first, as JAX
    does."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        rng = getattr(opts, "image_augmentation.random_uniform.width_range",
                      [-5, 5]) or [-5, 5]
        self.low, self.high = int(rng[0]), int(rng[1])

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--image-augmentation.random-uniform.enable",
                           action="store_true", default=False)
        group.add_argument("--image-augmentation.random-uniform.width-range",
                           type=int, nargs=2, default=[-5, 5])
        return parser

    def draw(self, rng: Optional[Rng], n: int) -> np.ndarray:
        return _integers(numpy_draws(rng), self.low, self.high + 1, n)

    def apply(self, data: Dict, params: np.ndarray = None) -> Dict:
        arr = np.asarray(data["image"]).astype(np.int32)
        noise = np.asarray(params).reshape(arr.shape)
        data["image"] = np.where(arr >= 0, (arr + noise) % 256, arr)
        return data
