"""Image-text datasets for CLIP and their collate (counterpart of
cvnets_tpu/data/datasets/multi_modal_img_text/base_multi_modal_img_text.py).

* ``flickr``: (image, caption) pairs from the root's ``captions.tsv``,
  ``captions.txt`` (image TAB caption) or ``annotations.jsonl`` (``image`` and
  ``caption`` keys), the first that exists.
* ``img_text_tar``: ``*.tar`` shards of ``<key>.{jpg,jpeg,png,webp,bmp}`` and
  ``<key>.{txt,json}`` members, indexed from
  ``--dataset.img-text-tar.metadata-file`` (``{"samples": [[shard, image
  member, caption member], ...]}``) or by a walk of the shards' headers, and
  read with one open handle a shard a thread; a flickr manifest in the root
  is read instead when there is one.
* ``imagenet_zero_shot``: an ImageFolder (the classification dataset's
  evaluation transforms) and, for the text tower, ``class_caption_tokens()``:
  (C, 80, L) tokens of CLIP's 80 prompt templates a class, the class names
  from ``--dataset.zero-shot.class-names-file`` (one a line, in the folder's
  class order), else the canonical 1,000 ImageNet names for a folder of
  wnids or of 1,000 classes, else the folder names. The templates and names
  are the package's own copy (``assets/clip_imagenet_zero_shot.json``).

An image-text item is ``{"samples": {"image": uint8 (3, H, W), "text": int64
(L,)}, "targets": index, "sample_id": index}``: training takes a random
resized crop to the sampler's size, evaluation a resize to it; pixels stay
uint8 to the device, where the train step normalizes them. An image that
cannot be read gives the JAX placeholder (zeros, the empty caption's tokens,
target -1), which the collate replaces by a valid sample. As the other
datasets, an item comes in two parts: ``draw_params`` in the loader's
producer thread, in sample order (the image's size from its header, the
crop from the epoch's generator, and the caption's tokens: the tokenizer
runs on the host in that thread), then ``get_item`` (decode and transform)
in a worker thread. Images go through Pillow one by one; the native
whole-batch decoder is the classification dataset's only.

``multi_modal_img_text_collate_fn`` stacks the items and, under
``--dataset.multi-modal-img-text.trunc-seq-len``, cuts the text to the
longest caption of the batch rounded up to 16 tokens (:361-385).
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import os
import random
import re
import tarfile
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.data.collate import COLLATE_FN_REGISTRY
from cvnets_tpu_torch.data.collate.collate_functions import default_collate_fn
from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
from cvnets_tpu_torch.data.datasets.classification.base_image_classification_dataset import (
    BaseImageClassificationDataset,
)
from cvnets_tpu_torch.data.datasets.dataset_base import BaseDataset, BaseImageDataset
from cvnets_tpu_torch.data.text_tokenizer import build_tokenizer
from cvnets_tpu_torch.data.transforms.common import Compose
from cvnets_tpu_torch.data.transforms.image import (
    RandomResizedCrop,
    Resize,
    ToFloatTensor,
    resize_image,
)
from cvnets_tpu_torch.utils import logger

ZERO_SHOT_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                               "clip_imagenet_zero_shot.json")


def load_zero_shot_asset() -> Tuple[List[str], List[str]]:
    """CLIP's 80 prompt templates and the 1,000 ImageNet class names."""
    with open(ZERO_SHOT_ASSET) as f:
        blob = json.load(f)
    return blob["templates"], blob["imagenet_class_names"]


def _tokenizer(opts):
    if getattr(opts, "text_tokenizer.name", None) is None:
        setattr(opts, "text_tokenizer.name", "clip")
    return build_tokenizer(opts)


def arguments_multi_modal_img_text(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Image-text datasets")
    group.add_argument("--dataset.multi-modal-img-text.context-length", type=int, default=None,
                       help="Token context length; --model.text.context-length when unset")
    group.add_argument("--dataset.multi-modal-img-text.zero-shot-eval", action="store_true",
                       default=False,
                       help="Validate zero-shot classification instead of the training "
                            "dataset's val split")
    group.add_argument("--dataset.multi-modal-img-text.zero-shot.name", type=str, default=None)
    group.add_argument("--dataset.multi-modal-img-text.zero-shot.root-val", type=str,
                       default=None)
    group.add_argument("--dataset.multi-modal-img-text.trunc-seq-len", action="store_true",
                       default=False,
                       help="Cut a batch's text to its longest caption, rounded up to 16 tokens")
    return parser


class BaseMultiModalImgText(BaseImageDataset):
    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        self.tokenizer = _tokenizer(opts)
        self._empty_text = self.tokenizer("")
        self.samples: List[Tuple[str, str]] = []  # (image path, caption)
        self._rng = random.Random(getattr(opts, "common.seed", 0) or 0)
        self._chains: Dict[Tuple[int, int], Compose] = {}

    def _chain(self, size: Tuple[int, int]) -> Compose:
        if size not in self._chains:
            first = (RandomResizedCrop(self.opts, size=size) if self.is_training
                     else Resize(self.opts, img_size=list(size)))
            self._chains[size] = Compose(self.opts, [first, ToFloatTensor(self.opts)])
        return self._chains[size]

    def __len__(self) -> int:
        return len(self.samples)

    def image_size(self, idx: int) -> Optional[Tuple[int, int]]:
        return self.image_size_pil(self.samples[idx][0])

    def read_image(self, idx: int) -> Optional[np.ndarray]:
        return self.read_image_pil(self.samples[idx][0])

    def caption(self, idx: int) -> str:
        return self.samples[idx][1]

    def _crop_size(self, sample_size_and_index) -> Tuple[int, int, int]:
        crop_h, crop_w, idx = self._parse_batch_tuple(sample_size_and_index)
        return (224, 224, idx) if crop_h <= 0 else (crop_h, crop_w, idx)

    def draw_params(self, sample_size_and_index, rng: random.Random):
        """(the chain's parameters, the caption's tokens), or None (and no
        draw) for an image that cannot be read."""
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        size = self.image_size(idx)
        if size is None:
            return None
        return self._chain((crop_h, crop_w)).draw(rng, size)[0], self.tokenizer(self.caption(idx))

    def get_item(self, sample_size_and_index, params) -> Dict:
        crop_h, crop_w, idx = self._crop_size(sample_size_and_index)
        img = self.read_image(idx) if params is not None else None
        if img is None:
            return {"samples": {"image": torch.zeros((3, crop_h, crop_w), dtype=torch.uint8),
                                "text": self._empty_text.clone()},
                    "targets": -1, "sample_id": idx}
        chain_params, text = params
        arr = self._chain((crop_h, crop_w)).apply(
            {"image": torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)},
            chain_params)["image"]
        if tuple(arr.shape[-2:]) != (crop_h, crop_w):  # every sample of a batch one shape
            arr = resize_image(arr, (crop_h, crop_w))
        return {"samples": {"image": arr, "text": text}, "targets": idx, "sample_id": idx}

    def __getitem__(self, sample_size_and_index) -> Dict:
        return self.get_item(sample_size_and_index,
                             self.draw_params(sample_size_and_index, self._rng))


@DATASET_REGISTRY.register(name="flickr", type="multi_modal_image_text")
class FlickrDataset(BaseMultiModalImgText):
    MANIFESTS = ("captions.tsv", "captions.txt", "annotations.jsonl")

    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        root = self.root or ""
        for name in self.MANIFESTS:
            manifest = os.path.join(root, name)
            if os.path.isfile(manifest):
                with open(manifest) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        if name.endswith(".jsonl"):
                            blob = json.loads(line)
                            img, cap = blob["image"], blob["caption"]
                        else:
                            img, cap = line.split("\t", 1)
                        self.samples.append((os.path.join(root, img), cap))
                break

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        # the family's flags, once (the tar dataset, a subclass, adds its own)
        return arguments_multi_modal_img_text(parser) if cls is FlickrDataset else parser


@DATASET_REGISTRY.register(name="img_text_tar", type="multi_modal_image_text")
class ImgTextTarDataset(FlickrDataset):
    IMG_EXT = (".jpg", ".jpeg", ".png", ".webp", ".bmp")
    TXT_EXT = (".txt", ".json")

    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        self.entries: List[Tuple[str, str, str]] = []  # (shard, image member, caption member)
        self._tls = threading.local()
        if not self.samples:  # no flickr manifest in the root
            self._index_shards()

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--dataset.img-text-tar.metadata-file", type=str, default=None,
                           help='Shard index {"samples": [[shard, image member, caption '
                                'member], ...]}: no walk of the shards at start')
        group.add_argument("--dataset.multi-modal-img-text.img-text-tar.metadata-file",
                           type=str, default=None)
        group.add_argument("--dataset.multi-modal-img-text.img-text-tar.parallel-download",
                           action="store_true", default=False)
        group.add_argument("--dataset.multi-modal-img-text.img-text-tar.s3-bucket-path",
                           type=str, default=None, help="Not ported: shards are local files")
        return parser

    def _index_shards(self) -> None:
        root = self.root or ""
        prefix = "dataset.multi_modal_img_text.img_text_tar."
        if getattr(self.opts, prefix + "s3_bucket_path", None):
            logger.error("img_text_tar reads local shards only; download them and point "
                         "--dataset.root-train at them")
        meta = (getattr(self.opts, prefix + "metadata_file", None)
                or getattr(self.opts, "dataset.img_text_tar.metadata_file", None))
        if meta and os.path.isfile(meta):
            with open(meta) as f:
                for shard, img_m, txt_m in json.load(f).get("samples", []):
                    self.entries.append((shard if os.path.isabs(shard)
                                         else os.path.join(root, shard), img_m, txt_m))
            return
        for shard in sorted(glob.glob(os.path.join(root, "*.tar"))):
            imgs: Dict[str, str] = {}
            txts: Dict[str, str] = {}
            with tarfile.open(shard) as tf:  # the headers only
                for m in tf:
                    if not m.isfile():
                        continue
                    key, ext = os.path.splitext(m.name)
                    if ext.lower() in self.IMG_EXT:
                        imgs[key] = m.name
                    elif ext.lower() in self.TXT_EXT:
                        txts[key] = m.name
            self.entries += [(shard, imgs[k], txts[k]) for k in sorted(imgs) if k in txts]

    def _member(self, shard: str, member: str):
        """A file object of ``member``, through this thread's handle of ``shard``."""
        handles = getattr(self._tls, "handles", None)
        if handles is None:
            handles = self._tls.handles = {}
        if shard not in handles:
            handles[shard] = tarfile.open(shard)
        return handles[shard].extractfile(member)

    @staticmethod
    def parse_caption(raw: bytes, member: str) -> str:
        text = raw.decode("utf-8", errors="replace")
        if member.endswith(".json"):
            try:
                blob = json.loads(text)
                return blob.get("caption") or blob.get("text") or ""
            except json.JSONDecodeError:
                return ""
        return text.strip()

    def __len__(self) -> int:
        return len(self.entries) if self.entries else len(self.samples)

    def image_size(self, idx: int) -> Optional[Tuple[int, int]]:
        if not self.entries:
            return super().image_size(idx)
        shard, img_m, _ = self.entries[idx]
        image = self._pil()
        try:
            with image.open(self._member(shard, img_m)) as img:
                return img.height, img.width
        except Exception:
            return None

    def read_image(self, idx: int) -> Optional[np.ndarray]:
        if not self.entries:
            return super().read_image(idx)
        shard, img_m, _ = self.entries[idx]
        image = self._pil()
        try:
            with image.open(io.BytesIO(self._member(shard, img_m).read())) as img:
                return np.array(img.convert("RGB"))
        except Exception:
            return None

    def caption(self, idx: int) -> str:
        if not self.entries:
            return super().caption(idx)
        shard, _, txt_m = self.entries[idx]
        try:
            return self.parse_caption(self._member(shard, txt_m).read(), txt_m)
        except Exception:
            return ""


@DATASET_REGISTRY.register(name="imagenet_zero_shot", type="multi_modal_image_text")
class ImageNetZeroShot(BaseDataset):
    def __init__(self, opts, is_training: bool = False, is_evaluation: bool = True,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=False, is_evaluation=True)
        self.inner = BaseImageClassificationDataset(opts, is_training=False, is_evaluation=True)
        self.tokenizer = _tokenizer(opts)
        self.templates, imagenet_names = load_zero_shot_asset()
        classes = self.inner.classes
        names_file = getattr(opts, "dataset.zero_shot.class_names_file", None)
        if names_file and os.path.isfile(names_file):
            with open(names_file) as f:
                self.class_names = [line.strip() for line in f if line.strip()]
        elif (len(classes) == len(imagenet_names)
              or all(re.fullmatch(r"n\d{8}", c) for c in classes[:5])):
            # wnid folder names would make meaningless captions
            self.class_names = imagenet_names[:len(classes)]
        else:
            self.class_names = list(classes)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--dataset.zero-shot.class-names-file", type=str, default=None)
        group.add_argument("--dataset.zero-shot.templates", type=str, default=None,
                           help="Parsed and not read, as in the JAX package: the 80 "
                                "templates are the package's")
        return parser

    def class_caption_tokens(self) -> torch.Tensor:
        """int64 (n_classes, n_templates, context length)."""
        return torch.stack([torch.stack([self.tokenizer(t.format(class_name=name))
                                         for t in self.templates])
                            for name in self.class_names])

    def __len__(self) -> int:
        return len(self.inner)

    def draw_params(self, sample_size_and_index, rng: random.Random):
        return self.inner.draw_params(sample_size_and_index, rng)

    def get_item(self, sample_size_and_index, params) -> Dict:
        return self.inner.get_item(sample_size_and_index, params)

    def __getitem__(self, sample_size_and_index) -> Dict:
        return self.inner[sample_size_and_index]


@COLLATE_FN_REGISTRY.register(name="multi_modal_img_text_collate_fn")
def multi_modal_img_text_collate_fn(batch: List[Dict], opts=None) -> Dict:
    out = default_collate_fn(batch, opts)
    samples = out.get("samples")
    if (opts is None or not getattr(opts, "dataset.multi_modal_img_text.trunc_seq_len", False)
            or not isinstance(samples, dict) or "text" not in samples):
        return out
    text = samples["text"]
    # the place after the last non-pad token of any row, rounded up to 16 tokens
    last = int(((text != 0) * torch.arange(1, text.shape[-1] + 1)).max()) if text.numel() else 1
    bucket = max(16, (last + 15) // 16 * 16)
    if bucket < text.shape[-1]:
        samples = dict(samples, text=text[..., :bucket].contiguous())
        if samples.get("padding_mask") is not None:
            samples["padding_mask"] = samples["padding_mask"][..., :bucket].contiguous()
        out["samples"] = samples
    return out
