"""ImageFolder-backed classification dataset (counterpart of
cvnets_tpu/data/datasets/classification/base_image_classification_dataset.py):
a directory a class in sorted order, the training subset of
``--dataset.percentage-of-samples`` or ``--dataset.num-samples-per-category``
(a ``np.random.default_rng`` on the seed, per class), a corrupt image read as
zeros with label -1 (the collate replaces it), and the train and validation
transform chains at the sampler's crop size.

An item comes in two parts so that the loader can draw every random parameter
in sample order before its threads decode: ``draw_params(t, rng)`` probes the
image's size (its header) and draws the transforms' parameters from ``rng``;
``get_item(t, params)`` reads the image and transforms it. ``dataset[t]`` does
both with the dataset's own ``random.Random``.

The whole-batch native route (the JAX dataset's ``fetch_batch_native``,
:180-266): under ``--dataset.decoder native`` a training batch of JPEG files
with random resized crop on and no host policy (``_native_batch_eligible``,
the JAX eligibility of :169-178) is read as bytes, each header's size probed
once an index (``_dims_cache``, nvJPEG's parser on a card, Pillow's on the
CPU), the crop box and flip drawn by the chain's own ``draw`` from the
loader's generator in sample order (so ``native`` and ``pil`` draw the same
boxes and flips for one seed), and decoded, cropped, resized and mirrored in
one call of ``cvnets_tpu_torch.native`` into the collated uint8 batch, on the
card or on the CPU. A failed file's slot takes a repeat of a valid one in
place, its target and id too; with none valid the targets are -1 (the JAX
protocol, :255-265). The per-sample ``_native_fast_path`` is not ported: the
port's loader always takes the whole batch, and nothing else calls it.

Not ported: the host AutoAugment and timm RandAugment, which run on Pillow
(ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from cvnets_tpu_torch.constants import SUPPORTED_IMAGE_EXTNS
from cvnets_tpu_torch.data.datasets.dataset_base import BaseImageDataset
from cvnets_tpu_torch.data.transforms.common import Compose
from cvnets_tpu_torch.data.transforms.image import (
    CenterCrop,
    RandomHorizontalFlip,
    RandomResizedCrop,
    Resize,
    ToFloatTensor,
)
from cvnets_tpu_torch.utils import logger

# host-tier policies of the JAX package that run on Pillow
_UNPORTED_HOST_AUGMENTATION = ("image_augmentation.auto_augment.enable",
                               "image_augmentation.rand_augment.use_timm_library")


def _find_classes(root: str) -> Tuple[List[str], Dict[str, int]]:
    classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
    return classes, {c: i for i, c in enumerate(classes)}


class BaseImageClassificationDataset(BaseImageDataset):
    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        for dest in _UNPORTED_HOST_AUGMENTATION:
            if is_training and getattr(opts, dest, False):
                raise NotImplementedError(
                    f"not ported yet: --{dest.replace('_', '-')} runs on Pillow in the "
                    "JAX package (ROADMAP.md queue 1 item 13)")
        self.samples = self._subset(self._find_samples())
        self.n_classes = len(self.classes)
        self._rng = random.Random(getattr(opts, "common.seed", 0) or 0)
        self._chains: Dict[Tuple[int, int], Compose] = {}
        self._dims_cache: Dict[int, Tuple[int, int]] = {}  # index -> JPEG (width, height)

    def _find_samples(self) -> List[Tuple[str, int]]:
        root = self.root
        if not root or not os.path.isdir(root):
            logger.error(f"Classification dataset root not found: {root!r}")
        self.classes, self.class_to_idx = _find_classes(root)
        samples = []
        for cls_name in self.classes:
            for dirpath, _, files in sorted(os.walk(os.path.join(root, cls_name))):
                samples += [(os.path.join(dirpath, f), self.class_to_idx[cls_name])
                            for f in sorted(files)
                            if os.path.splitext(f)[1].lower() in SUPPORTED_IMAGE_EXTNS]
        return samples

    def _subset(self, samples: List[Tuple[str, int]]) -> List[Tuple[str, int]]:
        """The training subset, drawn class by class in order of first appearance."""
        opts = self.opts
        pct = getattr(opts, "dataset.percentage_of_samples", 100.0) or 100.0
        n_per_cat = getattr(opts, "dataset.num_samples_per_category", -1) or -1
        if not self.is_training or (pct >= 100.0 and n_per_cat <= 0):
            return samples
        if n_per_cat > 0 and 0 < pct < 100:
            logger.error("Specify only one of dataset.num_samples_per_category and "
                         "dataset.percentage_of_samples")
        seed = getattr(opts, "dataset.sample_selection_random_seed", None)
        if seed is None:
            seed = getattr(opts, "common.seed", 0) or 0
        rng = np.random.default_rng(seed)
        by_class: Dict[int, List] = {}
        for s in samples:
            by_class.setdefault(s[1], []).append(s)
        keep = []
        for cls_samples in by_class.values():
            n_keep = (min(n_per_cat, len(cls_samples)) if n_per_cat > 0
                      else max(1, int(len(cls_samples) * pct / 100.0)))
            keep += [cls_samples[i] for i in rng.permutation(len(cls_samples))[:n_keep]]
        return keep

    def share_dataset_arguments(self) -> Dict:
        return {"model.classification.n_classes": self.n_classes}

    def _training_transforms(self, size: Tuple[int, int]) -> Compose:
        opts = self.opts
        transforms = [RandomResizedCrop(opts, size=size)
                      if getattr(opts, "image_augmentation.random_resized_crop.enable", False)
                      else Resize(opts, img_size=list(size))]
        if getattr(opts, "image_augmentation.random_horizontal_flip.enable", False):
            transforms.append(RandomHorizontalFlip(opts))
        return Compose(opts, transforms + [ToFloatTensor(opts)])

    def _validation_transforms(self, size: Tuple[int, int]) -> Compose:
        opts = self.opts
        transforms = []
        if getattr(opts, "image_augmentation.resize.enable", False):
            transforms.append(Resize(opts))
        transforms.append(CenterCrop(opts)
                          if getattr(opts, "image_augmentation.center_crop.enable", False)
                          else Resize(opts, img_size=list(size)))
        return Compose(opts, transforms + [ToFloatTensor(opts)])

    def _chain(self, size: Tuple[int, int]) -> Compose:
        if size not in self._chains:
            self._chains[size] = (self._training_transforms(size) if self.is_training
                                  else self._validation_transforms(size))
        return self._chains[size]

    def __len__(self) -> int:
        return len(self.samples)

    def image_size(self, idx: int) -> Optional[Tuple[int, int]]:
        return self.image_size_pil(self.samples[idx][0])

    def read_image(self, idx: int) -> Optional[np.ndarray]:
        return self.read_image_pil(self.samples[idx][0])

    def _crop_size(self, sample_size_and_index) -> Tuple[int, int, int]:
        crop_h, crop_w, idx = self._parse_batch_tuple(sample_size_and_index)
        return (224, 224, idx) if crop_h <= 0 else (crop_h, crop_w, idx)

    def draw_params(self, sample_size_and_index, rng: random.Random):
        """The transforms' parameters for one item, or None (and no draw) for an
        image that cannot be read, as the JAX dataset draws nothing for one."""
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        size = self.image_size(idx)
        return None if size is None else self._chain((crop_h, crop_w)).draw(rng, size)[0]

    def get_item(self, sample_size_and_index, params) -> Dict:
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        target = self.samples[idx][1]
        img = self.read_image(idx) if params is not None else None
        if img is None:
            return {"samples": torch.zeros((3, crop_h, crop_w), dtype=torch.uint8),
                    "targets": -1, "sample_id": idx}
        data = self._chain((crop_h, crop_w)).apply(
            {"image": torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)}, params)
        arr = data["image"]
        if tuple(arr.shape[-2:]) != (crop_h, crop_w):  # every sample of a batch one shape
            from cvnets_tpu_torch.data.transforms.image import resize_image

            arr = resize_image(arr, (crop_h, crop_w))
        return {"samples": arr, "targets": int(target), "sample_id": idx}

    def __getitem__(self, sample_size_and_index) -> Dict:
        return self.get_item(sample_size_and_index,
                             self.draw_params(sample_size_and_index, self._rng))

    def _native_batch_eligible(self, batch_tuples=None) -> bool:
        """Training, ``--dataset.decoder native``, random resized crop, no host
        policy and, for ``batch_tuples``, JPEG files only."""
        opts = self.opts
        if not (self.is_training and getattr(opts, "dataset.decoder", "pil") == "native"
                and getattr(opts, "image_augmentation.random_resized_crop.enable", False)
                and not any(getattr(opts, d, False) for d in _UNPORTED_HOST_AUGMENTATION)):
            return False
        return batch_tuples is None or all(
            str(self.samples[self._crop_size(t)[2]][0]).lower().endswith((".jpg", ".jpeg"))
            for t in batch_tuples)

    def _read_bytes(self, idx: int) -> bytes:
        """The file's bytes; an unreadable file reads as none (and fails its decode)."""
        try:
            with open(self.samples[idx][0], "rb") as f:
                return f.read()
        except OSError:
            return b""

    def fetch_batch_native(self, batch_tuples, rng: random.Random,
                           device: Union[str, torch.device] = "cuda", decoder=None) -> Dict:
        """The collated batch of ``batch_tuples`` through the native decoder on
        ``device`` (work on a card is enqueued on its current stream; ``decoder``
        a ``native.JpegDecoder`` there, or None for one made for the call): ``samples``
        uint8 (B, 3, H, W) on ``device``, ``targets`` and ``sample_id`` int64
        on the host."""
        from cvnets_tpu_torch import native

        crop_h, crop_w, _ = self._crop_size(batch_tuples[0])
        idxs = [self._crop_size(t)[2] for t in batch_tuples]
        blobs = [self._read_bytes(i) for i in idxs]
        missing = [k for k, i in enumerate(idxs) if i not in self._dims_cache]
        if missing:
            dims = native.jpeg_dimensions_batch([blobs[k] for k in missing], device, decoder)
            for k, (w, h) in zip(missing, dims):
                self._dims_cache[idxs[k]] = (int(w), int(h))
        chain = self._chain((crop_h, crop_w))
        crops, flips = [], []
        for idx in idxs:
            w, h = self._dims_cache[idx]
            crop, flip = (0, 0, -1, -1), False
            if w > 0 and h > 0:  # an unreadable header draws nothing, as on the pil route
                for t, p in zip(chain.img_transforms, chain.draw(rng, (h, w))[0]):
                    if isinstance(t, RandomResizedCrop):
                        top, left, ch, cw = p
                        crop = (left, top, cw, ch)
                    elif isinstance(t, RandomHorizontalFlip):
                        flip = bool(p)
            crops.append(crop)
            flips.append(flip)
        samples, ok = native.decode_rrc_batch(blobs, crops, flips, (crop_h, crop_w),
                                              device, decoder)
        targets = np.asarray([self.samples[i][1] for i in idxs], np.int64)
        sample_ids = np.asarray(idxs, np.int64)
        if not ok.all():  # the JAX protocol: failed slots take valid ones in place
            valid = np.nonzero(ok)[0]
            if valid.size == 0:
                targets[:] = -1
            else:
                bad = np.nonzero(~ok)[0]
                repl = valid[np.arange(bad.size) % valid.size]
                for b, r in zip(bad.tolist(), repl.tolist()):  # copies on the device
                    samples[b].copy_(samples[r])
                targets[bad], sample_ids[bad] = targets[repl], sample_ids[repl]
        return {"samples": samples, "targets": torch.from_numpy(targets),
                "sample_id": torch.from_numpy(sample_ids)}
