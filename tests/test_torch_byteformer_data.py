"""ByteFormer's data path in the port against the JAX package's, on the CPU:

* ``pil_save`` in every encoding (JPEG at two qualities, PNG, TIFF, fCHW,
  fHWC; ``file-encoding`` over ``encoding``) byte for byte on the same pixels:
  the port's uint8 CHW sample through the collate's entry against JAX's float
  HWC in [0, 1], as each dataset gives it;
* each byte transform with JAX's draws injected (a ``np.random.RandomState``
  on the seed JAX's ``np.random`` was seeded with), byte for byte;
* both collates' padded batches, bucket included, against JAX's, with the
  random transforms on; a chain without ``pil_save`` (the privacy-camera
  yamls) keeps JAX's values;
* the loader hands the collate its per-epoch generator in the producer thread
  (the same batches for one seed and epoch), and the native whole-batch route
  stays off for the byte collates.
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import both_opts  # noqa: E402


def _image(seed: int, h: int = 40, w: int = 52) -> np.ndarray:
    """Smooth colour fields and grain, uint8 HWC, every value 0-255 present
    in some image of the test (0 and 255 at the corners)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    field = np.stack([(yy * 255 // (h - 1)), (xx * 255 // (w - 1)),
                      ((yy + xx) * 255 // (h + w - 2))], -1)
    img = np.clip(field + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
    img[0, 0], img[-1, -1] = 0, 255
    return img


def _jax_sample(img: np.ndarray) -> np.ndarray:
    """What the JAX dataset gives (ToFloatTensor, image.py:570-572)."""
    return img.astype(np.float32) / 255.0


def _port_sample(img: np.ndarray) -> torch.Tensor:
    """What the port's dataset gives: uint8 CHW."""
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))


ENCODINGS = [["--image-augmentation.pil-save.encoding", "jpeg",
              "--image-augmentation.pil-save.quality", "60"],
             ["--image-augmentation.pil-save.encoding", "jpeg"],
             ["--image-augmentation.pil-save.encoding", "png"],
             ["--image-augmentation.pil-save.encoding", "tiff"],
             ["--image-augmentation.pil-save.encoding", "fCHW"],
             ["--image-augmentation.pil-save.encoding", "fHWC"],
             ["--image-augmentation.pil-save.encoding", "png",
              "--image-augmentation.pil-save.file-encoding", "fCHW"]]


@pytest.mark.parametrize("args", ENCODINGS,
                         ids=["jpeg_q60", "jpeg_q100", "png", "tiff", "fCHW", "fHWC",
                              "file_encoding_wins"])
def test_pil_save_gives_jax_bytes_on_the_same_pixels(args):
    from cvnets_tpu.data.transforms.image_bytes import PILSave as JaxPILSave
    from cvnets_tpu_torch.data.collate.byteformer_collate_functions import _as_jax_sample
    from cvnets_tpu_torch.data.transforms.image_bytes import PILSave

    opts_jax, opts = both_opts(args)
    for seed in range(3):
        img = _image(seed)
        want = JaxPILSave(opts_jax)({"image": _jax_sample(img)})["image"]
        got = PILSave(opts).apply({"image": _as_jax_sample(_port_sample(img))})["image"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        # uint8 pixels directly give the same bytes: v / 255 · 255 truncates back to v
        direct = PILSave(opts).apply({"image": img})["image"]
        np.testing.assert_array_equal(direct, want)
    if "fCHW" in args:
        np.testing.assert_array_equal(got, img.transpose(2, 0, 1).reshape(-1))


BYTE_CASES = {
    "reverse": ["--image-augmentation.shuffle-bytes.enable"],
    "random_shuffle": ["--image-augmentation.shuffle-bytes.enable",
                       "--image-augmentation.shuffle-bytes.mode", "random_shuffle"],
    "cyclic_half_length": ["--image-augmentation.shuffle-bytes.enable",
                           "--image-augmentation.shuffle-bytes.mode", "cyclic_half_length"],
    "stride": ["--image-augmentation.shuffle-bytes.enable",
               "--image-augmentation.shuffle-bytes.mode", "stride",
               "--image-augmentation.shuffle-bytes.stride", "7"],
    "window_shuffle": ["--image-augmentation.shuffle-bytes.enable",
                       "--image-augmentation.shuffle-bytes.mode", "window_shuffle",
                       "--image-augmentation.shuffle-bytes.window-size", "64"],
    "byte_permutation": ["--image-augmentation.byte-permutation.enable"],
    "mask_positions": ["--image-augmentation.mask-positions.enable",
                       "--image-augmentation.mask-positions.keep-frac", "0.1"],
    "random_uniform": ["--image-augmentation.random-uniform.enable",
                       "--image-augmentation.random-uniform.width-range", "-20", "20"],
}
_TRANSFORM = {"reverse": "ShuffleBytes", "random_shuffle": "ShuffleBytes",
              "cyclic_half_length": "ShuffleBytes", "stride": "ShuffleBytes",
              "window_shuffle": "ShuffleBytes", "byte_permutation": "BytePermutation",
              "mask_positions": "MaskPositions", "random_uniform": "RandomUniformNoise"}


@pytest.mark.parametrize("case", list(BYTE_CASES))
def test_byte_transforms_match_jax_with_its_draws_injected(case):
    import cvnets_tpu.data.transforms.image_bytes as J
    import cvnets_tpu_torch.data.transforms.image_bytes as P

    opts_jax, opts = both_opts(BYTE_CASES[case])
    jt, pt = getattr(J, _TRANSFORM[case])(opts_jax), getattr(P, _TRANSFORM[case])(opts)
    for seed, n in ((0, 777), (1, 64 * 5 + 3), (2, 50)):
        x = np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)
        x[-3:] = -1  # padding values (negative) stay negative where JAX keeps them
        np.random.seed(seed)
        want = jt({"image": x.copy()})["image"]
        got = pt.apply({"image": x.copy()}, pt.draw(np.random.RandomState(seed), n))["image"]
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def _jax_collate_with_seed(fn, batch, opts, seed):
    np.random.seed(seed)
    return fn(batch, opts)


def _image_batch(n: int = 4):
    imgs = [_image(10 + i, h=40 + 8 * i, w=44) for i in range(n)]
    return imgs, [{"samples": _jax_sample(im), "targets": i} for i, im in enumerate(imgs)], \
        [{"samples": _port_sample(im), "targets": i, "sample_id": i} for i, im in enumerate(imgs)]


IMAGE_CHAINS = {
    "jpeg_q60": ["--image-augmentation.pil-save.enable",
                 "--image-augmentation.pil-save.quality", "60"],
    "jpeg_shuffled_noisy_permuted": [
        "--image-augmentation.pil-save.enable",
        "--image-augmentation.shuffle-bytes.enable",
        "--image-augmentation.shuffle-bytes.mode", "random_shuffle",
        "--image-augmentation.random-uniform.enable",
        "--image-augmentation.byte-permutation.enable"],
    "png_padding_index_0": ["--image-augmentation.pil-save.enable",
                            "--image-augmentation.pil-save.encoding", "png",
                            "--model.classification.byteformer.padding-index", "0"],
    # the privacy-camera yamls: no pil_save, so the float pixels reach
    # random_uniform, which casts them to int32 (JAX's values, kept)
    "privacy_camera": ["--image-augmentation.mask-positions.enable",
                       "--image-augmentation.mask-positions.keep-frac", "0.1",
                       "--image-augmentation.random-uniform.enable"],
}


@pytest.mark.parametrize("chain", list(IMAGE_CHAINS))
def test_image_collate_gives_jax_padded_batch_and_bucket(chain):
    from cvnets_tpu.data.collate.byteformer_collate_functions import (
        byteformer_image_collate_fn as jax_collate,
    )
    from cvnets_tpu_torch.data.collate.byteformer_collate_functions import (
        byteformer_image_collate_fn,
    )

    opts_jax, opts = both_opts(IMAGE_CHAINS[chain])
    _, jax_batch, port_batch = _image_batch()
    want = _jax_collate_with_seed(jax_collate, jax_batch, opts_jax, 5)
    got = byteformer_image_collate_fn(port_batch, opts, rng=np.random.RandomState(5))
    assert got["samples"].dtype == torch.int32 and got["targets"].dtype == torch.int64
    np.testing.assert_array_equal(got["samples"].numpy(), want["samples"])
    np.testing.assert_array_equal(got["targets"].numpy(), want["targets"])
    bucket = got["samples"].shape[1]
    assert bucket >= 256 and bucket & (bucket - 1) == 0
    if chain == "privacy_camera":  # JAX's cast: pixels below 255 become 0, then noise
        assert set(np.unique(got["samples"].numpy())) <= set(range(-1, 256))


def test_audio_collate_writes_float_clips_and_keeps_file_bytes():
    """``torchaudio_save`` turns a float clip into its wav bytes; an integer
    sample (the file's own bytes) passes as it is, as JAX skips it."""
    from cvnets_tpu.data.collate.byteformer_collate_functions import (
        byteformer_audio_collate_fn as jax_collate,
    )
    from cvnets_tpu_torch.data.collate.byteformer_collate_functions import (
        byteformer_audio_collate_fn,
    )

    args = ["--audio-augmentation.torchaudio-save.enable",
            "--audio-augmentation.torchaudio-save.encoding-dtype", "int16",
            "--image-augmentation.byte-permutation.enable"]
    opts_jax, opts = both_opts(args)
    rng = np.random.default_rng(4)
    clips = [np.clip(rng.standard_normal(n) * 0.3, -1, 1).astype(np.float32)
             for n in (100, 300)]
    raw = rng.integers(0, 256, 700).astype(np.int32)
    jax_batch = [{"samples": c.copy(), "targets": i} for i, c in enumerate(clips)] + [
        {"samples": raw.copy(), "targets": 2}]
    port_batch = [{"samples": c.copy(), "targets": i} for i, c in enumerate(clips)] + [
        {"samples": raw.copy(), "targets": 2}]
    want = _jax_collate_with_seed(jax_collate, jax_batch, opts_jax, 0)
    got = byteformer_audio_collate_fn(port_batch, opts, rng=random.Random(0))
    np.testing.assert_array_equal(got["samples"].numpy(), want["samples"])
    assert got["samples"].shape == (3, 1024)
    assert isinstance(port_batch[0]["samples"], np.ndarray)  # the caller's items untouched
    assert port_batch[0]["samples"].dtype == np.float32


def test_loader_draws_from_its_epoch_generator_and_keeps_the_native_route_off(tmp_path):
    """The loader passes the producer's ``random.Random`` to the collate: one
    seed and epoch give the same batches, another epoch others; a dataset
    that could take the native route does not with a byte collate."""
    from PIL import Image

    from cvnets_tpu_torch.data.data_loaders import create_train_val_loader

    for c in range(2):
        (tmp_path / f"c{c}").mkdir()
        for i in range(4):
            Image.fromarray(_image(20 + 4 * c + i)).save(tmp_path / f"c{c}" / f"{i}.jpg",
                                                         quality=90)
    args = ["--common.config-file",
            os.path.join(REPO, "config/classification/imagenet/byteformer.yaml"),
            "--common.override-kwargs", f"dataset.root_train={tmp_path}",
            f"dataset.root_val={tmp_path}", "dataset.workers=2",
            "dataset.train_batch_size0=4", "sampler.bs.crop_size_width=32",
            "sampler.bs.crop_size_height=32",
            "image_augmentation.shuffle_bytes.enable=true",
            "image_augmentation.shuffle_bytes.mode=random_shuffle"]
    from cvnets_tpu_torch.options.opts import get_training_arguments

    runs = []
    for epoch in (0, 0, 1):
        opts = get_training_arguments(args=args)
        loader, _, sampler = create_train_val_loader(opts, device="cpu")
        assert getattr(opts, "dataset.decoder") == "native"
        assert loader.dataset._native_batch_eligible() and not loader._native([(32, 32, 0)])
        sampler.set_epoch(epoch)
        runs.append([b["samples"] for b in loader])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(runs[0], runs[2]))
