"""The port's segmentation transforms against the JAX package's (Pillow), given
the same parameters: the same seed in Python's ``random`` for the JAX
transform and in the ``random.Random`` the port draws from. Masks are held bit
for bit, images within one uint8 level of Pillow (two after a resize of a
resized image, as in the whole chain), downscaling and upscaling, bilinear and
bicubic:

* ``resize_mask`` against Pillow's ``NEAREST`` over many (in, out) sizes, and
  ``F.interpolate``'s "nearest-exact" shown to differ from it;
* ``Resize`` and ``RandomHorizontalFlip`` carrying the mask; the flip's image
  unchanged for an image without one;
* ``RandomShortSizeResize`` (truncated sizes, short sides drawn on both sides of
  the image's);
* ``RandomCrop``: the bilinear fit of a small image, ``pad-if-needed`` with a
  ``mask-fill``, and under ``seg-class-max-ratio`` the offset the JAX retries
  settle on (the port draws its 11 candidates up front);
* the dataset's whole training chain (short-side resize, flip, crop).
"""

from __future__ import annotations

import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import both_opts  # noqa: E402

SEEDS = range(6)


def _image(rng, h, w):
    """A smooth image (a sampled gradient plus mild noise) and a blob mask of
    a few labels, with some ignore pixels."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                    ((xx + yy) * 127 // max(h + w - 2, 1))], -1)
    img = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)
    coarse = rng.integers(0, 6, (4, 5)).astype(np.uint8)
    coarse[0, 0] = 255
    mask = coarse[yy * 4 // h, xx * 5 // w]
    return img, mask


def _port(img, mask):
    return {"image": torch.from_numpy(img).permute(2, 0, 1).contiguous(),
            "mask": torch.from_numpy(mask)}


def _jax(img, mask):
    return {"image": img.copy(), "mask": mask.astype(np.int32)}


def _check(got, want, levels=1):
    img = got["image"].permute(1, 2, 0).numpy().astype(int)
    ref = np.asarray(want["image"]).astype(int)
    assert img.shape == ref.shape
    assert np.abs(img - ref).max() <= levels
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))


def test_resize_mask_is_pillows_nearest():
    from PIL import Image

    from cvnets_tpu_torch.data.transforms.image import resize_mask

    rng = np.random.default_rng(0)
    differ = 0
    for h, w in [(7, 13), (37, 50), (97, 131), (375, 500), (512, 683)]:
        mask = rng.integers(0, 256, (h, w)).astype(np.uint8)
        for oh, ow in [(5, 9), (19, 64), (256, 256), (512, 512), (768, 1024), (h * 2, w * 3)]:
            want = np.asarray(Image.fromarray(mask).resize((ow, oh), Image.NEAREST))
            got = resize_mask(torch.from_numpy(mask), (oh, ow)).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} -> {(oh, ow)}")
            exact = torch.nn.functional.interpolate(
                torch.from_numpy(mask)[None, None].float(), size=(oh, ow),
                mode="nearest-exact")[0, 0].to(torch.uint8).numpy()
            differ += not np.array_equal(exact, want)
    assert differ > 0  # why the port does not call "nearest-exact"


@pytest.mark.parametrize("size,interp", [((40, 56), "bilinear"), ((96, 80), "bicubic"),
                                         ((31, 150), "bicubic")])
def test_resize_carries_the_mask(size, interp):
    from cvnets_tpu.data.transforms.image import Resize as JaxResize
    from cvnets_tpu_torch.data.transforms.image import Resize

    jax_opts, opts = both_opts(["--image-augmentation.resize.interpolation", interp])
    img, mask = _image(np.random.default_rng(1), 61, 77)
    _check(Resize(opts, img_size=list(size)).apply(_port(img, mask), None),
           JaxResize(jax_opts, img_size=list(size))(_jax(img, mask)))


@pytest.mark.parametrize("seed", SEEDS)
def test_flip_carries_the_mask(seed):
    from cvnets_tpu.data.transforms.image import RandomHorizontalFlip as JaxFlip
    from cvnets_tpu_torch.data.transforms.image import RandomHorizontalFlip

    jax_opts, opts = both_opts([])
    img, mask = _image(np.random.default_rng(seed), 20, 30)
    flip = RandomHorizontalFlip(opts)
    params, _ = flip.draw(random.Random(seed), (20, 30))
    random.seed(seed)
    _check(flip.apply(_port(img, mask), params), JaxFlip(jax_opts)(_jax(img, mask)), levels=0)
    alone = flip.apply({"image": _port(img, mask)["image"]}, params)  # no mask: as before
    assert set(alone) == {"image"}


RSSR = ["--image-augmentation.random-short-size-resize.enable",
        "--image-augmentation.random-short-size-resize.short-side-min", "30",
        "--image-augmentation.random-short-size-resize.short-side-max", "120",
        "--image-augmentation.random-short-size-resize.max-img-dim", "150"]


@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
def test_random_short_size_resize_up_and_down(interp):
    from cvnets_tpu.data.transforms.image import RandomShortSizeResize as JaxRSSR
    from cvnets_tpu_torch.data.transforms.image import RandomShortSizeResize

    jax_opts, opts = both_opts(
        RSSR + ["--image-augmentation.random-short-size-resize.interpolation", interp])
    port, ref = RandomShortSizeResize(opts), JaxRSSR(jax_opts)
    ups = 0
    for seed in range(8):
        img, mask = _image(np.random.default_rng(seed), 53, 71)
        params, out_size = port.draw(random.Random(seed), (53, 71))
        random.seed(seed)
        want = ref(_jax(img, mask))
        got = port.apply(_port(img, mask), params)
        assert tuple(got["image"].shape[-2:]) == out_size == np.asarray(want["mask"]).shape
        _check(got, want)
        ups += out_size[0] > 53
    assert 0 < ups < 8


CROP = ["--image-augmentation.random-crop.enable"]


@pytest.mark.parametrize("extra,shape", [
    ([], (40, 90)),  # smaller than the crop in H: the bilinear fit
    (["--image-augmentation.random-crop.pad-if-needed",
      "--image-augmentation.random-crop.mask-fill", "7"], (40, 50)),
    ([], (90, 120)),  # no fit
])
def test_random_crop_fit_pad_and_offsets(extra, shape):
    from cvnets_tpu.data.transforms.image import RandomCrop as JaxCrop
    from cvnets_tpu_torch.data.transforms.image import RandomCrop

    jax_opts, opts = both_opts(CROP + extra)
    port, ref = RandomCrop(opts, size=(64, 64)), JaxCrop(jax_opts, size=(64, 64))
    for seed in range(4):
        img, mask = _image(np.random.default_rng(seed), *shape)
        params, out_size = port.draw(random.Random(seed), shape)
        random.seed(seed)
        want = ref({**_jax(img, mask), "crop_size": (64, 64)})
        got = port.apply(_port(img, mask), params)
        assert out_size == tuple(got["image"].shape[-2:]) == (64, 64)
        _check(got, want)
        if extra:
            assert (got["mask"] == 7).any()


def test_random_crop_retries_settle_where_jaxs_do():
    """A mask one class dominates but for a small blob: most 32² crops hold
    the class alone or nearly, so the 0.75 ratio sends the JAX transform
    drawing again; the port, given its up-front candidates, keeps the same
    crop. Seeds cover a first draw that passes, a retry and all 10 failing."""
    from cvnets_tpu.data.transforms.image import RandomCrop as JaxCrop
    from cvnets_tpu_torch.data.transforms.image import RandomCrop

    jax_opts, opts = both_opts(CROP + ["--image-augmentation.random-crop.seg-class-max-ratio",
                                       "0.75"])
    port, ref = RandomCrop(opts, size=(32, 32)), JaxCrop(jax_opts, size=(32, 32))
    img, _ = _image(np.random.default_rng(0), 120, 160)
    mask = np.zeros((120, 160), np.uint8)
    mask[50:70, 60:90] = 3
    mask[:10, :] = 255
    chosen = []
    for seed in range(40):
        params, _ = port.draw(random.Random(seed), (120, 160))
        assert len(params) == 11
        random.seed(seed)
        want = ref({**_jax(img, mask), "crop_size": (32, 32)})
        got = port.apply(_port(img, mask), params)
        _check(got, want, levels=0)
        kept = [k for k, (i, j) in enumerate(params)
                if torch.equal(got["image"], _port(img, mask)["image"][:, i:i + 32, j:j + 32])]
        chosen.append(kept[0])
    assert 0 in chosen and any(0 < k < 10 for k in chosen) and 10 in chosen


def test_training_chain_matches_jax():
    """The dataset's chain: ade20k's short side 30-120 bicubic, the flip and a
    64² crop (a fit where the resized image is smaller)."""
    from cvnets_tpu.data.datasets.segmentation.base_segmentation import (
        BaseImageSegmentationDataset as JaxBase,
    )
    from cvnets_tpu_torch.data.datasets.segmentation.base_segmentation import (
        BaseImageSegmentationDataset,
    )

    args = RSSR + CROP + ["--image-augmentation.random-short-size-resize.interpolation",
                          "bicubic", "--image-augmentation.random-horizontal-flip.enable"]
    jax_opts, opts = both_opts(args)
    port = BaseImageSegmentationDataset(opts, is_training=True)._training_transforms((64, 64))
    ref = JaxBase(jax_opts, is_training=True)._training_transforms((64, 64))
    for seed in range(6):
        img, mask = _image(np.random.default_rng(seed), 57, 83)
        params, size = port.draw(random.Random(seed), (57, 83))
        random.seed(seed)
        want = ref({**_jax(img, mask), "crop_size": (64, 64)})
        want["image"] = np.round(np.asarray(want["image"]) * 255.0)  # ToFloatTensor's [0, 1]
        got = port.apply(_port(img, mask), params)
        assert size == (64, 64)
        _check(got, want, levels=2)
