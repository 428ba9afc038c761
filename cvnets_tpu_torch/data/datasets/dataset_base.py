"""Base datasets (counterpart of cvnets_tpu/data/datasets/dataset_base.py).

A dataset is a host-side object: its items are asked for with the sampler's
``(crop_h, crop_w, index)`` tuples and are dicts of tensors and ints. Moving
them to the card is the Trainer's work.

Images and masks are read through Pillow, imported inside the reader (and
inside ``native/plain.py`` and the offline segmentation eval's file I/O). A
training batch of JPEG files under ``--dataset.decoder native`` (the default)
is decoded whole by ``cvnets_tpu_torch.native`` instead: nvJPEG and a
hand-written kernel on a card, its plain version (Pillow) on the CPU (the
classification dataset's ``fetch_batch_native``).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np


NO_PILLOW = ("reading image files needs Pillow, which is not installed; only a "
             "training batch of JPEG files under --dataset.decoder native on a CUDA card "
             "is read without it")


class BaseDataset:
    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        self.opts = opts
        self.is_training = is_training
        self.is_evaluation = is_evaluation
        self.root = self._dataset_root()

    def _dataset_root(self) -> Optional[str]:
        if self.is_training:
            return getattr(self.opts, "dataset.root_train", None)
        if self.is_evaluation:
            return (getattr(self.opts, "dataset.root_test", None)
                    or getattr(self.opts, "dataset.root_val", None))
        return getattr(self.opts, "dataset.root_val", None)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseDataset:
            return parser
        group = parser.add_argument_group(title="Dataset arguments")
        group.add_argument("--dataset.root-train", type=str, default="")
        group.add_argument("--dataset.root-val", type=str, default="")
        group.add_argument("--dataset.root-test", type=str, default="")
        group.add_argument("--dataset.name", type=str, default=None)
        group.add_argument("--dataset.decoder", type=str, default="native",
                           choices=["pil", "native"],
                           help="native: a training batch of JPEG files is decoded, "
                                "cropped, resized and flipped whole (nvJPEG and a CUDA "
                                "kernel on a card); pil: each sample through Pillow")
        group.add_argument("--dataset.category", type=str, default="classification")
        group.add_argument("--dataset.train-batch-size0", type=int, default=128)
        group.add_argument("--dataset.val-batch-size0", type=int, default=1)
        group.add_argument("--dataset.eval-batch-size0", type=int, default=1)
        group.add_argument("--dataset.workers", type=int, default=-1)
        group.add_argument("--dataset.prefetch-factor", type=int, default=2)
        group.add_argument("--dataset.pin-memory", action="store_true", default=False,
                           help="Config-compat: batches bound for a card are pinned "
                                "whatever it says")
        group.add_argument("--dataset.persistent-workers", action="store_true",
                           default=False,
                           help="Config-compat: the loader's worker threads live as long "
                                "as the loader")
        group.add_argument("--dataset.collate-fn-name-train", type=str,
                           default="default_collate_fn")
        group.add_argument("--dataset.collate-fn-name-val", type=str,
                           default="default_collate_fn")
        group.add_argument("--dataset.collate-fn-name-test", type=str,
                           default="default_collate_fn")
        group.add_argument("--dataset.percentage-of-samples", type=float, default=100.0)
        group.add_argument("--dataset.imagenet-shift.wnid-file", type=str, default=None,
                           help="ImageNet's 1000 wnids in order, one a line, for a shift "
                                "set's logit projection")
        group.add_argument("--dataset.sample-efficient-training.enable",
                           action="store_true", default=False)
        group.add_argument("--dataset.detection.no-background-id", action="store_true",
                           default=False,
                           help="Contiguous detection labels start at 0 (no background "
                                "slot)")
        group.add_argument("--dataset.padding-index", type=int, default=None,
                           help="Padding token id of text pipelines: its embedding is zero")
        group.add_argument("--dataset.disable-val", action="store_true", default=False,
                           help="Skip building the validation dataset/loader")
        group.add_argument("--dataset.num-samples-per-category", type=int, default=-1,
                           help="Balanced training subset: keep this many samples per "
                                "class (exclusive with percentage-of-samples)")
        group.add_argument("--dataset.sample-selection-random-seed", type=int,
                           default=None,
                           help="Seed for subset sampling; defaults to --common.seed")
        return parser

    def share_dataset_arguments(self) -> Dict[str, Any]:
        """Values to push back into opts (e.g. n_classes) once the dataset is built."""
        return {}

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, sample_size_and_index: Tuple[int, int, int]) -> Dict:
        raise NotImplementedError

    @staticmethod
    def _parse_batch_tuple(sample_size_and_index: Union[Tuple[int, int, int], int]
                           ) -> Tuple[int, int, int]:
        """Samplers yield (crop_h, crop_w, idx); a plain int idx is taken too."""
        if isinstance(sample_size_and_index, (tuple, list)):
            return tuple(sample_size_and_index)
        return (-1, -1, int(sample_size_and_index))

    def __repr__(self) -> str:
        return (f"{self.__class__.__name__}(root={self.root}, "
                f"is_training={self.is_training}, n_samples={len(self)})")


class BaseImageDataset(BaseDataset):
    """Image files (and segmentation masks) through Pillow: an unreadable file
    reads as None."""

    @staticmethod
    def _pil():
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(NO_PILLOW) from e
        return Image

    @classmethod
    def image_size_pil(cls, path: str) -> Optional[Tuple[int, int]]:
        """(height, width) from the file's header, or None if it cannot be read."""
        image = cls._pil()
        try:
            with image.open(path) as img:
                return img.height, img.width
        except Exception:
            return None

    @classmethod
    def read_mask_pil(cls, path: str) -> Optional[np.ndarray]:
        """The file's stored values, HW (a palette PNG's indices, not its
        colours), or None if it cannot be read."""
        image = cls._pil()
        try:
            with image.open(path) as img:
                return np.array(img)
        except Exception:
            return None

    @classmethod
    def read_image_pil(cls, path: str) -> Optional[np.ndarray]:
        """The file's pixels as RGB, HWC uint8, or None if it cannot be read."""
        image = cls._pil()
        try:
            with image.open(path) as img:
                return np.array(img.convert("RGB"))
        except Exception:
            return None
