"""ByteFormer's collates (counterpart of
cvnets_tpu/data/collate/byteformer_collate_functions.py).

``byteformer_image_collate_fn`` runs each sample through the byte transforms
that are enabled, in JAX's order (``pil_save`` → ``shuffle_bytes`` →
``mask_positions`` → ``random_uniform`` → ``byte_permutation``), flattens it,
and pads the batch with ``padding_index`` to the power-of-two bucket of its
longest sequence, at least 256. The JAX package pads to a bucket to bound its
recompiles; since padding tokens take part in ByteFormer's attention (its
masks are not applied by default), the padded length changes the logits, so
the port pads to the same bucket. ``byteformer_audio_collate_fn`` first
writes a float clip to wav bytes under ``torchaudio_save``; an integer sample
(a file's bytes, what Speech Commands gives by default) is left as it is.

The batch: ``samples`` int32 (B, bucket), ``targets`` int64. A sample enters
the chain as the JAX dataset gives it: an image as float32 HWC in [0, 1]
(from the port's uint8 CHW, exactly), so ``pil_save`` encodes the same
pixels, and a chain without ``pil_save`` sees the same values (the
privacy-camera yamls: JAX casts them to int32, so every pixel but 255 becomes
0; the port keeps that). A corrupt sample (target -1) is kept, as in JAX.

The collates take the loader's per-epoch ``random.Random`` as ``rng`` (the
loader passes it to a collate whose ``takes_rng`` is set), from which the
random byte transforms draw in sample order; a ``np.random.RandomState``
there draws what JAX's ``np.random`` does after ``np.random.seed``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from cvnets_tpu_torch.data.collate import COLLATE_FN_REGISTRY
from cvnets_tpu_torch.data.transforms.image_bytes import (
    BytePermutation,
    MaskPositions,
    PILSave,
    RandomUniformNoise,
    Rng,
    ShuffleBytes,
)

PAD_VALUE = -1
MIN_BUCKET = 256
_BYTE_CHAIN = (("image_augmentation.pil_save.enable", PILSave),
               ("image_augmentation.shuffle_bytes.enable", ShuffleBytes),
               ("image_augmentation.mask_positions.enable", MaskPositions),
               ("image_augmentation.random_uniform.enable", RandomUniformNoise),
               ("image_augmentation.byte_permutation.enable", BytePermutation))


def bucket_len(n: int) -> int:
    """The least power of two ≥ ``n``, at least ``MIN_BUCKET``."""
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


def pad_batch(seqs: List[np.ndarray], opts=None) -> np.ndarray:
    """(B, bucket) int32, each row a sequence then ``padding_index``."""
    pad = PAD_VALUE if opts is None else getattr(
        opts, "model.classification.byteformer.padding_index", PAD_VALUE)
    out = np.full((len(seqs), bucket_len(max(len(s) for s in seqs))), pad, np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out


def byte_chain(opts) -> list:
    """The enabled byte transforms, in JAX's order (:39-61), built a batch as
    the JAX collate builds them."""
    if opts is None:
        return []
    return [cls(opts) for flag, cls in _BYTE_CHAIN if getattr(opts, flag, False)]


def _as_jax_sample(sample) -> np.ndarray:
    """A sample as the JAX dataset gives it: uint8 CHW pixels as float32 HWC
    in [0, 1]; anything else (bytes, a clip) as an array."""
    if isinstance(sample, torch.Tensor):
        if sample.dtype == torch.uint8 and sample.dim() == 3:
            return sample.permute(1, 2, 0).numpy().astype(np.float32) / 255.0
        sample = sample.numpy()
    return np.asarray(sample)


def _collate(batch: List[Dict], opts, rng: Optional[Rng]) -> Dict:
    chain = byte_chain(opts)
    seqs = []
    for b in batch:
        item = {"image": _as_jax_sample(b["samples"])}
        for t in chain:
            item = t.apply(item, t.draw(rng, int(np.asarray(item["image"]).size)))
        seqs.append(np.asarray(item["image"]).reshape(-1))
    return {"samples": torch.from_numpy(pad_batch(seqs, opts)),
            "targets": torch.tensor([int(b["targets"]) for b in batch], dtype=torch.int64)}


@COLLATE_FN_REGISTRY.register(name="byteformer_image_collate_fn")
def byteformer_image_collate_fn(batch: List[Dict], opts=None,
                                rng: Optional[Rng] = None) -> Dict:
    return _collate(batch, opts, rng)


@COLLATE_FN_REGISTRY.register(name="byteformer_audio_collate_fn")
def byteformer_audio_collate_fn(batch: List[Dict], opts=None,
                                rng: Optional[Rng] = None) -> Dict:
    if opts is not None and getattr(opts, "audio_augmentation.torchaudio_save.enable",
                                    False):
        from cvnets_tpu_torch.data.transforms.audio_bytes import TorchaudioSave

        save = TorchaudioSave(opts)
        batch = [dict(b) for b in batch]
        for b in batch:
            s = _as_jax_sample(b["samples"])
            if np.issubdtype(s.dtype, np.floating):
                item = {"samples": {"audio": s},
                        "metadata": b.get("metadata", {"audio_fps": 16000})}
                b["samples"] = save(item)["samples"]["audio"]
    return _collate(batch, opts, rng)


byteformer_image_collate_fn.takes_rng = True
byteformer_audio_collate_fn.takes_rng = True
