"""The port's segmentation datasets against the JAX package's on tiny folders
that Pillow writes into ``tmp_path`` (JPEG images, palette PNG masks):
``ade20k``, ``pascal`` (its SBD list layout and its ImageSets layout) and
``coco_segmentation``: the file lists, the number of classes each shares, the
masks as read and adjusted (ADE20k's raw 0 to the ignore label, the rest down
by one; a palette PNG read as its indices), validation and evaluation samples
(images within one uint8 level of the JAX float images × 255, two where an
image is resized twice, masks bit for bit), a training sample given the same
seed, an unreadable pair read as a
black image with an all-ignore mask, and the loader's uint8 (B, H, W) targets.
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import both_opts  # noqa: E402


def _pair(rng, h, w, n_labels):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1), (xx * yy) % 256], -1)
    coarse = rng.integers(0, n_labels, (3, 4))
    coarse[0, 0] = 0  # ADE20k's "other", read as the ignore label
    return img.astype(np.uint8), coarse[yy * 3 // h, xx * 4 // w].astype(np.uint8)


def _write(img_path, mask_path, img, mask):
    from PIL import Image

    from cvnets_tpu_torch.utils.color_map import Colormap

    for path in (img_path, mask_path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(img_path, quality=95)
    pal = Image.frombytes("P", (mask.shape[1], mask.shape[0]), mask.tobytes())
    pal.putpalette(Colormap().get_color_map_list())
    pal.save(mask_path)


SIZES = [(45, 60), (60, 45), (50, 70)]


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    rng = np.random.default_rng(0)
    ade, voc, voc_sets, coco = (str(root / n) for n in ("ade", "voc", "voc_sets", "coco"))
    for split, names in (("training", ["a", "c", "b"]), ("validation", ["v1", "v0"])):
        for i, name in enumerate(names):
            img, mask = _pair(rng, *SIZES[i % 3], 151)
            _write(f"{ade}/images/{split}/{name}.jpg",
                   f"{ade}/annotations/{split}/{name}.png", img, mask)
    for split, names in (("train_aug", ["x", "y"]), ("val", ["z", "w", "q"])):
        lines = []
        for i, name in enumerate(names):
            img, mask = _pair(rng, *SIZES[i % 3], 21)
            _write(f"{voc}/VOC2012/JPEGImages/{name}.jpg",
                   f"{voc}/VOC2012/SegmentationClassAug/{name}.png", img, mask)
            lines.append(f"/JPEGImages/{name}.jpg /SegmentationClassAug/{name}.png")
        os.makedirs(f"{voc}/VOC2012/list", exist_ok=True)
        with open(f"{voc}/VOC2012/list/{split}.txt", "w") as f:
            f.write("\n".join(lines) + "\n")
    for split, names in (("train", ["s1"]), ("val", ["s2", "s3"])):
        for i, name in enumerate(names):
            img, mask = _pair(rng, *SIZES[i % 3], 21)
            _write(f"{voc_sets}/VOC2012/JPEGImages/{name}.jpg",
                   f"{voc_sets}/VOC2012/SegmentationClass/{name}.png", img, mask)
        os.makedirs(f"{voc_sets}/VOC2012/ImageSets/Segmentation", exist_ok=True)
        with open(f"{voc_sets}/VOC2012/ImageSets/Segmentation/{split}.txt", "w") as f:
            f.write("\n".join(names) + "\n")
    for split, names in (("train2017", ["c2", "c1"]), ("val2017", ["c3"])):
        for i, name in enumerate(names):
            img, mask = _pair(rng, *SIZES[i % 3], 21)
            _write(f"{coco}/{split}/{name}.jpg", f"{coco}/masks/{split}/{name}.png", img, mask)
    with open(f"{ade}/images/validation/v2.jpg", "wb") as f:  # unreadable, as its mask
        f.write(b"not a jpeg")
    with open(f"{ade}/annotations/validation/v2.png", "wb") as f:
        f.write(b"not a png")
    return {"ade20k": ade, "pascal": voc, "pascal_sets": voc_sets, "coco_segmentation": coco}


def _datasets(folders, key, is_training, extra=(), is_evaluation=False):
    from cvnets_tpu.data.datasets import build_dataset_from_registry as jax_build
    from cvnets_tpu_torch.data.datasets import build_dataset_from_registry

    name = "pascal" if key.startswith("pascal") else key
    args = ["--dataset.category", "segmentation", "--dataset.name", name,
            "--dataset.root-train", folders[key], "--dataset.root-val", folders[key],
            "--dataset.decoder", "pil", *extra]
    jax_opts, opts = both_opts(args)
    kwargs = dict(is_training=is_training, is_evaluation=is_evaluation)
    return jax_build(jax_opts, **kwargs), build_dataset_from_registry(opts, **kwargs)


@pytest.mark.parametrize("key,n_classes,n_train,n_val", [
    ("ade20k", 150, 3, 3), ("pascal", 21, 2, 3), ("pascal_sets", 21, 1, 2),
    ("coco_segmentation", 21, 2, 1)])
def test_file_lists_and_classes_match(folders, key, n_classes, n_train, n_val):
    for is_training, n in ((True, n_train), (False, n_val)):
        ref, ds = _datasets(folders, key, is_training)
        assert (ds.images, ds.masks) == (ref.images, ref.masks)
        assert len(ds) == n
        assert ds.share_dataset_arguments() == ref.share_dataset_arguments() == {
            "model.segmentation.n_classes": n_classes}


@pytest.mark.parametrize("key", ["ade20k", "pascal", "coco_segmentation"])
def test_masks_read_as_indices_and_adjusted_as_in_jax(folders, key):
    ref, ds = _datasets(folders, key, False)
    raw = ds.read_mask(0)
    assert raw.ndim == 2 and raw.dtype == np.uint8  # the palette's indices, not RGB
    want = ref.adjust_mask_value(ref._load_mask(ref.masks[0]))
    got = ds.adjust_mask_value(raw)
    np.testing.assert_array_equal(got, want)
    if key == "ade20k":
        assert (raw == 0).any()
        np.testing.assert_array_equal(got[raw == 0], 255)
        np.testing.assert_array_equal(got[raw > 0], raw[raw > 0].astype(int) - 1)


def _check_sample(got, want, crop, levels=1):
    assert got["samples"].dtype == torch.uint8 and got["targets"].dtype == torch.uint8
    assert tuple(got["samples"].shape) == (3, *crop) and tuple(got["targets"].shape) == crop
    ref = np.round(np.asarray(want["samples"]) * 255.0).transpose(2, 0, 1)
    assert np.abs(got["samples"].numpy().astype(int) - ref).max() <= levels
    np.testing.assert_array_equal(got["targets"].numpy(), want["targets"])
    assert got["sample_id"] == want["sample_id"]


@pytest.mark.parametrize("key", ["ade20k", "pascal", "coco_segmentation"])
def test_validation_samples_match(folders, key):
    ref, ds = _datasets(folders, key, False)
    for idx in range(len(ds)):
        if key == "ade20k" and idx == 2:
            continue  # the unreadable pair, below
        _check_sample(ds[(48, 40, idx)], ref[(48, 40, idx)], (48, 40))


@pytest.mark.parametrize("extra,levels", [
    ([], 1),  # no resize: the last resize to the crop's size (bicubic, nearest)
    (["--evaluation.segmentation.resize-input-images"], 2),  # and then that one
    (["--evaluation.segmentation.resize-input-images-fixed-size", "40", "52"], 1)])
def test_evaluation_samples_match(folders, extra, levels):
    ref, ds = _datasets(folders, "ade20k", False, extra, is_evaluation=True)
    for idx in range(2):
        _check_sample(ds[(40, 52, idx)], ref[(40, 52, idx)], (40, 52), levels)


def test_training_sample_with_the_same_seed_matches(folders):
    args = ["--image-augmentation.random-short-size-resize.short-side-min", "30",
            "--image-augmentation.random-short-size-resize.short-side-max", "90",
            "--image-augmentation.random-short-size-resize.interpolation", "bicubic"]
    ref, ds = _datasets(folders, "ade20k", True, args)
    for seed, idx in ((0, 0), (1, 1), (2, 2), (3, 0)):
        random.seed(seed)
        want = ref[(48, 48, idx)]
        got = ds.get_item((48, 48, idx), ds.draw_params((48, 48, idx), random.Random(seed)))
        ref_img = np.round(np.asarray(want["samples"]) * 255.0).transpose(2, 0, 1)
        assert np.abs(got["samples"].numpy().astype(int) - ref_img).max() <= 2
        np.testing.assert_array_equal(got["targets"].numpy(), want["targets"])


def test_an_unreadable_pair_is_black_with_an_all_ignore_mask(folders):
    ref, ds = _datasets(folders, "ade20k", False)
    assert ds.draw_params((48, 40, 2), random.Random(0)) is None  # and no draw
    got, want = ds[(48, 40, 2)], ref[(48, 40, 2)]
    assert not got["samples"].any() and not np.asarray(want["samples"]).any()
    assert (got["targets"] == 255).all() and (np.asarray(want["targets"]) == 255).all()


def test_loader_batches_uint8_masks(folders):
    from cvnets_tpu_torch.data.data_loaders import create_train_val_loader
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=[
        "--dataset.category", "segmentation", "--dataset.name", "ade20k",
        "--dataset.root-train", folders["ade20k"], "--dataset.root-val", folders["ade20k"],
        "--dataset.workers", "2", "--dataset.train-batch-size0", "3",
        "--dataset.val-batch-size0", "3", "--sampler.bs.crop-size-width", "32",
        "--sampler.bs.crop-size-height", "24"])
    train, val, _ = create_train_val_loader(opts)
    assert getattr(opts, "model.segmentation.n_classes") == 150
    for loader in (train, val):
        batch = next(iter(loader))
        assert batch["samples"].dtype == batch["targets"].dtype == torch.uint8
        assert tuple(batch["samples"].shape) == (3, 3, 24, 32)
        assert tuple(batch["targets"].shape) == (3, 24, 32)
        assert int(batch["targets"][batch["targets"] != 255].max()) < 150
