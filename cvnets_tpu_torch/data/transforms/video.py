"""Video transforms (counterpart of cvnets_tpu/data/transforms/video.py).

A clip is ``data["video"]``, (T, H, W, C) uint8: the JAX transforms' float32
frames in [0, 1] are k / 255 of these, and each resampling goes through
Pillow as there, so an output here is the JAX output times 255, exactly.
The spatial transforms apply one window to every frame. Their random
choices are split from the work, as the image transforms' are:
``draw(rng, size_hw, crop_size)`` takes them from a ``random.Random`` in the
order the JAX transform takes them from the global ``random`` and returns
them with the output's (height, width); ``apply(data, params)`` does the
work; ``__call__(data, rng)`` does both. ``video_shuffle_audios`` draws its
numpy choices from a ``RandomState`` seeded from ``rng``.
``video_to_tensor`` gives (T, C, H, W) uint8; the train and eval steps make
floats of it on the device.

The ten registry entries (type ``video``) and the image tier's names as
aliases (:407-422) are JAX's. No dataset calls them: the Kinetics dataset
resizes each frame to the batch's crop and applies none (kinetics.py:47-73),
in JAX as here.
"""

from __future__ import annotations

import argparse
import math
import os
import random
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.data.transforms import TRANSFORMATIONS_REGISTRY
from cvnets_tpu_torch.data.transforms.common import BaseTransformation


def _pil_resize(frame: np.ndarray, size_wh: Tuple[int, int], resample=None) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray(np.ascontiguousarray(frame))
    out = img.resize(size_wh) if resample is None else img.resize(size_wh, resample)
    return np.asarray(out, np.uint8)


def _hw(size, default: Tuple[int, int]) -> Tuple[int, int]:
    size = size or default
    return tuple(size) if isinstance(size, (tuple, list)) else (size, size)


class VideoTransform(BaseTransformation):
    """A clip transform: ``draw`` then ``apply``."""

    def __init__(self, opts, size=None, **kwargs) -> None:
        super().__init__(opts)
        self.size = size

    def draw(self, rng: random.Random, size_hw: Tuple[int, int],
             crop_size=None) -> Tuple[Any, Tuple[int, int]]:
        return None, size_hw

    def __call__(self, data: Dict, rng: Optional[random.Random] = None) -> Dict:
        params, _ = self.draw(rng, tuple(np.asarray(data["video"]).shape[1:3]),
                              data.get("crop_size"))
        return self.apply(data, params)


@TRANSFORMATIONS_REGISTRY.register(name="video_resize", type="video")
class VideoResize(VideoTransform):
    """Every frame to ``size`` × ``size`` (Pillow's default resample)."""

    def __init__(self, opts, size=None, **kwargs) -> None:
        super().__init__(opts, size or getattr(opts, "video_augmentation.resize.size", 224))

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-augmentation.resize.enable", action="store_true",
                           default=False)
        group.add_argument("--video-augmentation.resize.size", type=int, nargs="+",
                           default=224)
        return parser

    def draw(self, rng, size_hw, crop_size=None):
        size = self.size[0] if isinstance(self.size, (list, tuple)) else self.size
        return None, (size, size)

    def apply(self, data: Dict, params) -> Dict:
        size = self.size[0] if isinstance(self.size, (list, tuple)) else self.size
        data["video"] = np.stack([_pil_resize(f, (size, size)) for f in data["video"]])
        return data


@TRANSFORMATIONS_REGISTRY.register(name="video_random_crop", type="video")
class VideoRandomCrop(VideoTransform):
    """One random window for every frame."""

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-augmentation.random-crop.enable", action="store_true",
                           default=False)
        return parser

    def draw(self, rng, size_hw, crop_size=None):
        h, w = size_hw
        ch, cw = _hw(self.size or crop_size, (h, w))
        ch, cw = min(ch, h), min(cw, w)
        return (rng.randint(0, h - ch), rng.randint(0, w - cw), ch, cw), (ch, cw)

    def apply(self, data: Dict, params) -> Dict:
        i, j, ch, cw = params
        data["video"] = np.asarray(data["video"])[:, i:i + ch, j:j + cw]
        return data


@TRANSFORMATIONS_REGISTRY.register(name="video_random_horizontal_flip", type="video")
class VideoRandomHorizontalFlip(VideoTransform):
    def __init__(self, opts, p: float = 0.5, **kwargs) -> None:
        super().__init__(opts)
        self.p = p

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-augmentation.random-horizontal-flip.enable",
                           action="store_true", default=False)
        return parser

    def draw(self, rng, size_hw, crop_size=None):
        return rng.random() < self.p, size_hw

    def apply(self, data: Dict, params) -> Dict:
        if params:
            data["video"] = np.ascontiguousarray(np.asarray(data["video"])[:, :, ::-1])
        return data


@TRANSFORMATIONS_REGISTRY.register(name="video_random_resized_crop", type="video")
class VideoRandomResizedCrop(VideoTransform):
    """One random scale / aspect window for the clip, resized bilinearly
    (video.py:96-149)."""

    def __init__(self, opts, size=None, **kwargs) -> None:
        super().__init__(opts, size)
        prefix = "video_augmentation.random_resized_crop."
        self.scale = tuple(getattr(opts, prefix + "scale", (0.08, 1.0)) or (0.08, 1.0))
        self.ratio = tuple(getattr(opts, prefix + "aspect_ratio", (3.0 / 4.0, 4.0 / 3.0))
                           or (3.0 / 4.0, 4.0 / 3.0))

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-augmentation.random-resized-crop.enable",
                           action="store_true", default=False)
        group.add_argument("--video-augmentation.random-resized-crop.scale", type=float,
                           nargs="+", default=(0.08, 1.0))
        group.add_argument("--video-augmentation.random-resized-crop.aspect-ratio",
                           type=float, nargs="+", default=(3.0 / 4.0, 4.0 / 3.0))
        return parser

    def draw(self, rng, size_hw, crop_size=None):
        h, w = size_hw
        th, tw = _hw(self.size or crop_size, (h, w))
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        ch = cw = None
        for _ in range(10):
            target_area = h * w * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            cw_c = int(round(math.sqrt(target_area * aspect)))
            ch_c = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw_c <= w and 0 < ch_c <= h:
                ch, cw = ch_c, cw_c
                break
        if ch is None:
            ch = cw = min(h, w)
        return (rng.randint(0, h - ch), rng.randint(0, w - cw), ch, cw, th, tw), (th, tw)

    def apply(self, data: Dict, params) -> Dict:
        from PIL import Image

        i, j, ch, cw, th, tw = params
        window = np.asarray(data["video"])[:, i:i + ch, j:j + cw]
        data["video"] = np.stack([_pil_resize(f, (tw, th), Image.BILINEAR) for f in window])
        return data


@TRANSFORMATIONS_REGISTRY.register(name="video_random_short_side_resize_crop", type="video")
class VideoRandomShortSideResizeCrop(VideoTransform):
    """The short side to a random length in [min, max] (bilinear), then
    ``VideoRandomCrop`` (video.py:152-192)."""

    def __init__(self, opts, size=None, **kwargs) -> None:
        super().__init__(opts, size)
        prefix = "video_augmentation.random_short_side_resize_crop."
        self.short_min = getattr(opts, prefix + "short_side_min", 256)
        self.short_max = getattr(opts, prefix + "short_side_max", 320)
        self.crop = VideoRandomCrop(opts, size=size)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        prefix = "--video-augmentation.random-short-side-resize-crop."
        group.add_argument(prefix + "enable", action="store_true", default=False)
        group.add_argument(prefix + "short-side-min", type=int, default=256)
        group.add_argument(prefix + "short-side-max", type=int, default=320)
        return parser

    def draw(self, rng, size_hw, crop_size=None):
        h, w = size_hw
        scale = rng.randint(self.short_min, self.short_max) / min(h, w)
        resized = (int(round(h * scale)), int(round(w * scale)))
        crop, out_hw = self.crop.draw(rng, resized, crop_size)
        return (resized, crop), out_hw

    def apply(self, data: Dict, params) -> Dict:
        from PIL import Image

        (nh, nw), crop = params
        data["video"] = np.stack([_pil_resize(f, (nw, nh), Image.BILINEAR)
                                  for f in data["video"]])
        return self.crop.apply(data, crop)


@TRANSFORMATIONS_REGISTRY.register(name="video_center_crop", type="video")
class VideoCenterCrop(VideoTransform):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-augmentation.center-crop.enable", action="store_true",
                           default=False)
        return parser

    def draw(self, rng, size_hw, crop_size=None):
        h, w = size_hw
        ch, cw = _hw(self.size or crop_size, (h, w))
        ch, cw = min(ch, h), min(cw, w)
        return ((h - ch) // 2, (w - cw) // 2, ch, cw), (ch, cw)

    def apply(self, data: Dict, params) -> Dict:
        i, j, ch, cw = params
        data["video"] = np.asarray(data["video"])[:, i:i + ch, j:j + cw]
        return data


@TRANSFORMATIONS_REGISTRY.register(name="video_to_tensor", type="video")
class VideoToTensor(VideoTransform):
    """(T, H, W, C) uint8 → (T, C, H, W) uint8 tensor."""

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-augmentation.to-tensor.enable", action="store_true",
                           default=True)
        return parser

    def apply(self, data: Dict, params) -> Dict:
        video = np.ascontiguousarray(np.asarray(data["video"], np.uint8))
        data["video"] = torch.from_numpy(video).permute(0, 3, 1, 2)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="video_crop_by_bounding_box", type="video")
class VideoCropByBoundingBox(VideoTransform):
    """Each frame cut to its box ``data["box_coordinates"]`` (T, 4), xyxy in
    pixels, grown by ``multiplier``, resized bilinearly (video.py:236-283)."""

    def __init__(self, opts, size=None, **kwargs) -> None:
        super().__init__(opts, size)
        self.multiplier = getattr(opts, "video_augmentation.crop_by_bounding_box.multiplier",
                                  1.0)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-augmentation.crop-by-bounding-box.enable",
                           action="store_true", default=False)
        group.add_argument("--video-augmentation.crop-by-bounding-box.multiplier",
                           type=float, default=1.0)
        return parser

    def draw(self, rng, size_hw, crop_size=None):
        th, tw = _hw(self.size or crop_size, size_hw)
        return (th, tw), (th, tw)

    def apply(self, data: Dict, params) -> Dict:
        from PIL import Image

        th, tw = params
        video = np.asarray(data["video"])
        h, w = video.shape[1:3]
        out = []
        for frame, box in zip(video, np.asarray(data["box_coordinates"], np.float32)):
            x1, y1, x2, y2 = box
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            bw, bh = (x2 - x1) * self.multiplier / 2, (y2 - y1) * self.multiplier / 2
            x1, x2 = int(max(cx - bw, 0)), int(min(cx + bw, w))
            y1, y2 = int(max(cy - bh, 0)), int(min(cy + bh, h))
            crop = frame[y1:max(y2, y1 + 1), x1:max(x2, x1 + 1)]
            out.append(_pil_resize(crop, (tw, th), Image.BILINEAR))
        data["video"] = np.stack(out)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="video_shuffle_audios", type="video")
class VideoShuffleAudios(VideoTransform):
    """Shuffles a round(n · ratio) subset of the clips' audios among
    themselves, none left in place, and marks which moved in
    ``is_shuffled`` (video.py:286-326)."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.shuffle_ratio = getattr(opts, "video_augmentation.shuffle_audios.shuffle_ratio",
                                     0.5)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-augmentation.shuffle-audios.enable",
                           action="store_true", default=False)
        group.add_argument("--video-augmentation.shuffle-audios.shuffle-ratio", type=float,
                           default=0.5)
        return parser

    def permutation(self, n: int, state: np.random.RandomState) -> np.ndarray:
        idx = np.arange(n)
        n_shuffle = int(round(n * self.shuffle_ratio))
        if n_shuffle >= 2:
            sel = state.choice(n, size=n_shuffle, replace=False)
            perm = state.permutation(sel)
            while np.any(perm == sel):  # a derangement of the chosen clips
                perm = state.permutation(sel)
            idx[sel] = perm
        return idx

    def __call__(self, data: Dict, rng: Optional[random.Random] = None) -> Dict:
        return self.apply(data, rng.getrandbits(32))

    def apply(self, data: Dict, params) -> Dict:
        audio = data.get("audio")
        if audio is None:
            return data
        audio = np.asarray(audio)
        n = audio.shape[0]
        if n < 2:
            data["is_shuffled"] = np.zeros((n,), np.int64)
            return data
        idx = self.permutation(n, np.random.RandomState(params))
        data["audio"] = audio[idx]
        data["is_shuffled"] = (idx != np.arange(n)).astype(np.int64)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="save-inputs", type="video")
class SaveInputs(VideoTransform):
    """Writes the clips an item holds as PNG frames under
    ``--video-augmentation.save-inputs.save-dir``, one folder an item
    (video.py:329-390), with the captions ``get_frame_captions(data)`` gives
    beside them."""

    def __init__(self, opts, get_frame_captions=None, **kwargs) -> None:
        super().__init__(opts)
        self.enable = getattr(opts, "video_augmentation.save_inputs.enable", False)
        self.save_dir = getattr(opts, "video_augmentation.save_inputs.save_dir", None)
        self.get_frame_captions = get_frame_captions
        if self.enable and not self.save_dir:
            from cvnets_tpu_torch.utils import logger

            logger.error("Please provide a value for --video-augmentation.save-inputs.save-dir")
        self._counter = 0

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-augmentation.save-inputs.enable", action="store_true",
                           default=False)
        group.add_argument("--video-augmentation.save-inputs.save-dir", type=str,
                           default=None)
        return parser

    def apply(self, data: Dict, params) -> Dict:
        if not self.enable:
            return data
        from PIL import Image

        video = np.asarray(data["video"] if "video" in data else data["samples"]["video"])
        clips = video[None] if video.ndim == 4 else video
        out_dir = os.path.join(self.save_dir, f"sample_{self._counter:06d}")
        os.makedirs(out_dir, exist_ok=True)
        for ci, clip in enumerate(clips):
            for fi, frame in enumerate(clip):
                Image.fromarray(np.asarray(frame, np.uint8)).save(
                    os.path.join(out_dir, f"clip{ci:02d}_frame{fi:04d}.png"))
        if self.get_frame_captions is not None:
            with open(os.path.join(out_dir, "captions.txt"), "w") as f:
                f.write("\n".join(self.get_frame_captions(data)))
        self._counter += 1
        return data


# the image tier's names, as JAX registers them for type "video" (:407-422)
for _name, _cls in (("resize", VideoResize), ("random_crop", VideoRandomCrop),
                    ("random_horizontal_flip", VideoRandomHorizontalFlip),
                    ("random_resized_crop", VideoRandomResizedCrop),
                    ("random_short_side_resize_crop", VideoRandomShortSideResizeCrop),
                    ("center_crop", VideoCenterCrop), ("to_tensor", VideoToTensor),
                    ("crop_by_bounding_box", VideoCropByBoundingBox),
                    ("shuffle-audios", VideoShuffleAudios)):
    TRANSFORMATIONS_REGISTRY.register(name=_name, type="video")(_cls)
