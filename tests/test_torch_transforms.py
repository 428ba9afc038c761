"""The port's host transforms (``cvnets_tpu_torch/data/transforms/image.py``)
against the JAX package's Pillow transforms:

* ``RandomResizedCrop.get_params`` drawing from ``random.Random(s)`` gives the
  boxes the JAX transform draws from the global ``random`` after
  ``random.seed(s)``, over image shapes that take every branch (the fallback
  center crops too);
* random resized crop (bicubic and bilinear), flip, resize of the shorter side
  to 288 (bicubic), exact resizes and the 256 center crop land within 1/255
  of Pillow's pixels (uint8 levels: at most 1 off), the shapes exactly;
* the chain the flagship yaml gives, draws and all, on one seed.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch
from PIL import Image

from cvnets_tpu.options.opts import get_training_arguments as jax_args
from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

SHAPES = [(375, 500), (500, 375), (288, 384), (61, 77), (256, 256)]


def _image(seed, hw):
    u8 = np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)
    return u8, torch.from_numpy(u8).permute(2, 0, 1)


def _hwc(t):
    return t.permute(1, 2, 0).numpy()


def _levels_off(port, pil_img):
    ref = np.asarray(pil_img)
    assert port.shape == ref.shape
    return int(np.abs(port.astype(np.int32) - ref.astype(np.int32)).max())


def _opts(extra=()):
    args = ["--image-augmentation.random-resized-crop.enable",
            "--image-augmentation.random-horizontal-flip.enable",
            "--image-augmentation.resize.size", "288",
            "--image-augmentation.resize.interpolation", "bicubic",
            "--image-augmentation.center-crop.size", "256", *extra]
    return jax_args(args=args), torch_args(args=args)


@pytest.mark.parametrize("seed", [0, 1, 2024])
def test_rrc_get_params_draws_the_jax_boxes(seed):
    from cvnets_tpu.data.transforms.image import RandomResizedCrop as JaxRRC
    from cvnets_tpu_torch.data.transforms.image import RandomResizedCrop

    opts_jax, opts_torch = _opts(["--image-augmentation.random-resized-crop.scale",
                                  "0.5", "1.0"])
    # tall and wide beyond the aspect range: the center-crop fallback
    shapes = SHAPES + [(1000, 40), (40, 1000), (3, 5)]
    ref, port = JaxRRC(opts_jax, size=(256, 256)), RandomResizedCrop(opts_torch, size=(256, 256))
    random.seed(seed)
    want = [ref.get_params(h, w) for _ in range(40) for h, w in shapes]
    rng = random.Random(seed)
    got = [port.get_params(h, w, rng) for _ in range(40) for h, w in shapes]
    assert got == want
    assert (473, 0, 53, 40) in got  # the fallback at (1000, 40): 40 wide at ratio 3/4


@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
@pytest.mark.parametrize("hw", SHAPES)
def test_rrc_and_flip_within_one_level_of_pillow(hw, interp):
    from cvnets_tpu.data.transforms.image import RandomHorizontalFlip as JaxFlip
    from cvnets_tpu.data.transforms.image import RandomResizedCrop as JaxRRC
    from cvnets_tpu_torch.data.transforms.common import Compose
    from cvnets_tpu_torch.data.transforms.image import RandomHorizontalFlip, RandomResizedCrop

    opts_jax, opts_torch = _opts(["--image-augmentation.random-resized-crop.interpolation",
                                  interp])
    u8, chw = _image(hw[0], hw)
    ref_chain = [JaxRRC(opts_jax, size=(256, 256)), JaxFlip(opts_jax)]
    chain = Compose(opts_torch, [RandomResizedCrop(opts_torch, size=(256, 256)),
                                 RandomHorizontalFlip(opts_torch)])
    random.seed(5)
    rng = random.Random(5)
    flips = 0
    for _ in range(8):
        data = {"image": Image.fromarray(u8)}
        for t in ref_chain:
            data = t(data)
        params, out_hw = chain.draw(rng, hw)
        flips += params[1]
        got = chain.apply({"image": chw}, params)["image"]
        assert out_hw == (256, 256) and got.dtype == torch.uint8
        assert _levels_off(_hwc(got), data["image"]) <= 1
    assert 0 < flips < 8  # seed 5 flips some of the eight


@pytest.mark.parametrize("hw", SHAPES + [(200, 150)])
def test_resize_288_bicubic_and_center_crop_256_within_one_level_of_pillow(hw):
    from cvnets_tpu.data.transforms.image import CenterCrop as JaxCenterCrop
    from cvnets_tpu.data.transforms.image import Resize as JaxResize
    from cvnets_tpu_torch.data.transforms.image import CenterCrop, Resize

    opts_jax, opts_torch = _opts()
    u8, chw = _image(1, hw)
    ref = JaxResize(opts_jax)({"image": Image.fromarray(u8)})["image"]
    got = Resize(opts_torch).apply({"image": chw}, None)["image"]
    assert _levels_off(_hwc(got), ref) <= 1
    assert Resize(opts_torch).output_size(hw) == tuple(got.shape[-2:])
    ref = JaxCenterCrop(opts_jax)({"image": ref})["image"]
    got = CenterCrop(opts_torch).apply({"image": got}, None)["image"]
    assert got.shape == (3, 256, 256)
    assert _levels_off(_hwc(got), ref) <= 1


def test_center_crop_of_a_smaller_image_pads_black_as_pillow():
    from cvnets_tpu.data.transforms.image import CenterCrop as JaxCenterCrop
    from cvnets_tpu_torch.data.transforms.image import CenterCrop

    opts_jax, opts_torch = _opts()
    u8, chw = _image(3, (200, 300))
    ref = JaxCenterCrop(opts_jax)({"image": Image.fromarray(u8)})["image"]
    got = CenterCrop(opts_torch).apply({"image": chw}, None)["image"]
    assert _levels_off(_hwc(got), ref) == 0


@pytest.mark.parametrize("size_hw", [(64, 80), (300, 200)])
@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
def test_exact_resize_within_one_level_of_pillow(size_hw, interp):
    from cvnets_tpu.data.transforms.image import Resize as JaxResize
    from cvnets_tpu_torch.data.transforms.image import Resize

    opts_jax, opts_torch = _opts(["--image-augmentation.resize.interpolation", interp])
    u8, chw = _image(2, (375, 500))
    ref = JaxResize(opts_jax, img_size=list(size_hw))({"image": Image.fromarray(u8)})["image"]
    got = Resize(opts_torch, img_size=list(size_hw)).apply({"image": chw}, None)["image"]
    assert _levels_off(_hwc(got), ref) <= 1


def test_resize_refuses_a_filter_it_does_not_have():
    from cvnets_tpu_torch.data.transforms.image import resize_image

    with pytest.raises(ValueError, match="bilinear, bicubic"):
        resize_image(torch.zeros(3, 8, 8, dtype=torch.uint8), (4, 4), "lanczos")
