"""The detection data path of the PyTorch port against the JAX package, on the
CPU:

* ``PhotometricDistort`` on uint8 tensors within one level of the JAX
  transform (Pillow's ``ImageEnhance`` and HSV code) given the same draws:
  the JAX transform's global ``random`` and ``np.random`` calls are pointed
  at one ``random.Random`` stream, the stream the port's ``draw`` takes;
* ``SSDCroping`` given the same draws: the same crop, kept boxes and labels,
  every kept box inside the crop and every kept center strictly inside;
* the COCO index and ``coco_ssd`` on a seeded folder (``tools/coco_corpus.py``:
  JPEG files, crowd boxes, an image with no boxes, a file cut short): the
  same images, classes and boxes as the JAX dataset; validation items within
  one level and their targets equal; training items given the same draws
  within two levels (the distortion and the resize each within one) with
  equal labels and locations within 1e-5; the damaged file a black image with
  every anchor background; ``coco_ssd_collate_fn``'s batch;
* ``compute_coco_map`` equal to the JAX package's to 1e-12 on random
  detections and on the golden cases of ``tests/test_coco_map_golden.py``.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from test_torch_detection_ops import SSD_ANCHOR_ARGS  # noqa: E402
from torch_port_helpers import both_opts  # noqa: E402

COCO_ARGS = SSD_ANCHOR_ARGS + ["--dataset.category", "detection",
                               "--dataset.name", "coco_ssd",
                               "--sampler.bs.crop-size-width", "96",
                               "--sampler.bs.crop-size-height", "96"]


class SameStream:
    """The JAX transforms' global draws (``random.*``, ``np.random.rand`` and
    ``np.random.permutation``) taken from one ``random.Random``."""

    def __init__(self, mp: pytest.MonkeyPatch, seed: int) -> None:
        from cvnets_tpu.data.transforms import image as jax_image

        rng = random.Random(seed)
        mp.setattr(jax_image, "random", rng)
        mp.setattr(np.random, "rand", lambda n: np.array([rng.random() for _ in range(n)]))
        mp.setattr(np.random, "permutation", lambda n: np.array(rng.sample(range(n), n)))


def _image(seed: int, h: int = 45, w: int = 61) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (4, 5, 3)).astype(np.uint8)
    smooth = base[np.arange(h) * 4 // h][:, np.arange(w) * 5 // w]
    return np.clip(smooth.astype(int) + rng.integers(-20, 21, (h, w, 3)), 0, 255
                   ).astype(np.uint8)


def _chw(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("p", [0.5, 1.0])
def test_photometric_distort_within_one_level_of_pillow(seed, p):
    from PIL import Image

    from cvnets_tpu.data.transforms.image import PhotometricDistort as JaxDistort
    from cvnets_tpu_torch.data.transforms.image import PhotometricDistort

    args = ["--image-augmentation.photo-metric-distort.p", str(p)]
    opts_jax, opts_torch = both_opts(args)
    img = _image(seed)
    params, _ = PhotometricDistort(opts_torch).draw(random.Random(seed), img.shape[:2])
    if p == 1.0:
        assert set(params) == {"brightness", "contrast_before", "saturation", "hue",
                               "permutation"}
    got = PhotometricDistort(opts_torch).apply({"image": _chw(img)}, params)["image"]
    with pytest.MonkeyPatch.context() as mp:
        SameStream(mp, seed)
        want = np.asarray(JaxDistort(opts_jax)({"image": Image.fromarray(img)})["image"])
    diff = np.abs(got.permute(1, 2, 0).numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1, (params, diff.max())


def test_photometric_distort_covers_contrast_after_the_colour_ops():
    from cvnets_tpu_torch.data.transforms.image import PhotometricDistort

    _, opts_torch = both_opts([])
    seen = set()
    for seed in range(40):
        seen |= set(PhotometricDistort(opts_torch).draw(random.Random(seed), (8, 8))[0])
    assert "contrast_after" in seen and "contrast_before" in seen


@pytest.mark.parametrize("seed", range(6))
def test_ssd_crop_keeps_the_jax_boxes_given_the_same_draws(seed):
    from PIL import Image

    from cvnets_tpu.data.transforms.image import SSDCroping as JaxCrop
    from cvnets_tpu_torch.data.transforms.image import SSDCroping

    opts_jax, opts_torch = both_opts([])
    rng = np.random.default_rng(seed)
    img = _image(seed, 80, 120)
    xy = rng.random((5, 2)) * [100, 60]
    boxes = np.concatenate([xy, xy + 5 + rng.random((5, 2)) * [40, 30]], 1).astype(np.float32)
    labels = rng.integers(1, 6, 5)
    crop = SSDCroping(opts_torch).draw_crop(random.Random(seed), (80, 120), boxes)
    got = SSDCroping.apply_crop({"image": _chw(img), "box_coordinates": boxes,
                                 "box_labels": labels}, crop)
    with pytest.MonkeyPatch.context() as mp:
        SameStream(mp, seed)
        want = JaxCrop(opts_jax)({"image": Image.fromarray(img), "box_coordinates": boxes,
                                  "box_labels": labels})
    np.testing.assert_array_equal(got["image"].permute(1, 2, 0).numpy(),
                                  np.asarray(want["image"]))
    np.testing.assert_array_equal(got["box_coordinates"], want["box_coordinates"])
    np.testing.assert_array_equal(got["box_labels"], want["box_labels"])
    if crop is not None:
        rect, keep = crop
        h, w = got["image"].shape[-2:]
        kept = got["box_coordinates"]
        assert (kept >= 0).all() and (kept[:, [0, 2]] <= w).all() and (kept[:, [1, 3]] <= h).all()
        centers = (boxes[keep, :2] + boxes[keep, 2:]) / 2
        assert ((centers > rect[:2]) & (centers < rect[2:])).all()


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from cvnets_tpu_torch.tools.coco_corpus import write_coco_corpus

    return write_coco_corpus(str(tmp_path_factory.mktemp("coco")), n_train=8, n_val=4,
                             max_side=120, seed=3)


def _datasets(coco, training: bool, extra=()):
    from cvnets_tpu.data.datasets.detection.coco_ssd import COCOSSDDataset as JaxCOCO
    from cvnets_tpu_torch.data.datasets.detection.coco_ssd import COCOSSDDataset

    opts_jax, opts_torch = both_opts(COCO_ARGS + ["--dataset.root-train", coco,
                                                  "--dataset.root-val", coco, *extra])
    return (JaxCOCO(opts_jax, is_training=training),
            COCOSSDDataset(opts_torch, is_training=training))


@pytest.mark.parametrize("training", [True, False])
def test_coco_index_images_classes_and_boxes(coco, training):
    jds, ds = _datasets(coco, training)
    assert ds.ids == jds.ids and len(ds) == len(jds)
    assert ds.n_classes == jds.n_classes == 6
    assert ds.share_dataset_arguments() == {"model.detection.n_classes": 6}
    assert ds.coco_id_to_contiguous_id == jds.coco_id_to_contiguous_id
    assert 0 in [len(ds.coco.load_anns(i)) for i in ds.coco.image_ids()]
    # the image without boxes: a training set drops it
    assert (0 in [len(ds.coco.load_anns(i)) for i in ds.ids]) != training
    for img_id in ds.ids:
        info = ds.coco.load_image_info(img_id)
        got = ds.get_boxes_and_labels(img_id, info["width"], info["height"])
        want = jds.get_boxes_and_labels(img_id, info["width"], info["height"])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    crowd = [a for i in ds.coco.image_ids() for a in ds.coco.load_anns(i) if a["iscrowd"]]
    assert crowd  # and dropped from every box list above


def _assert_items_match(got, want, levels: int):
    np.testing.assert_array_equal(got["targets"]["box_labels"].numpy(),
                                  want["targets"]["box_labels"])
    np.testing.assert_allclose(got["targets"]["box_coordinates"].numpy(),
                               want["targets"]["box_coordinates"], rtol=0, atol=1e-5)
    for key in ("image_id", "image_width", "image_height"):
        assert got["targets"][key] == want["targets"][key]
    pixels = got["samples"].permute(1, 2, 0).numpy().astype(int)
    diff = np.abs(pixels - np.round(want["samples"] * 255).astype(int))
    assert diff.max() <= levels


def test_validation_items_match(coco):
    jds, ds = _datasets(coco, training=False)
    for idx in range(len(ds)):
        _assert_items_match(ds[(96, 96, idx)], jds[(96, 96, idx)], levels=1)


@pytest.mark.parametrize("seed", range(4))
def test_training_items_match_given_the_same_draws(coco, seed):
    jds, ds = _datasets(coco, training=True)
    for idx in range(len(ds) - 1):  # the last training file is the damaged one
        params = ds.draw_params((96, 112, idx), random.Random(seed + 10 * idx))
        got = ds.get_item((96, 112, idx), params)
        with pytest.MonkeyPatch.context() as mp:
            SameStream(mp, seed + 10 * idx)
            want = jds[(96, 112, idx)]
        _assert_items_match(got, want, levels=2)


def test_the_damaged_file_is_black_with_every_anchor_background(coco):
    from cvnets_tpu_torch.data.datasets.detection.coco_ssd import coco_ssd_collate_fn

    jds, ds = _datasets(coco, training=True)
    damaged = len(ds) - 1
    assert ds.draw_params((96, 96, damaged), random.Random(0)) is None
    item = ds[(96, 96, damaged)]
    assert item["samples"].shape == (3, 96, 96) and not item["samples"].any()
    assert not item["targets"]["box_labels"].any()
    assert not jds[(96, 96, damaged)]["targets"]["box_labels"].any()
    batch = coco_ssd_collate_fn([ds[(96, 96, i)] for i in range(3)] + [item])
    assert batch["samples"].shape == (4, 3, 96, 96) and batch["samples"].dtype == torch.uint8
    n_anchors = item["targets"]["box_labels"].shape[0]
    assert batch["targets"]["box_labels"].shape == (4, n_anchors)
    assert batch["targets"]["box_coordinates"].shape == (4, n_anchors, 4)
    assert batch["targets"]["image_id"].tolist() == [ds.ids[i] for i in (0, 1, 2, damaged)]


def _random_detections(rng, n_imgs=5, n_classes=4):
    dets, gts = [], []
    for _ in range(n_imgs):
        n_gt, n_dt = int(rng.integers(0, 9)), int(rng.integers(0, 15))
        xy = rng.random((n_gt + n_dt, 2)) * 300
        wh = 5 + rng.random((n_gt + n_dt, 2)) * 150
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        gts.append({"boxes": boxes[:n_gt], "labels": rng.integers(1, n_classes, n_gt),
                    "iscrowd": rng.random(n_gt) < 0.15})
        jitter = boxes[:n_dt] + rng.normal(0, 8, (n_dt, 4)).astype(np.float32)
        dets.append({"boxes": jitter, "scores": rng.random(n_dt).astype(np.float32),
                     "labels": rng.integers(1, n_classes, n_dt)})
    return dets, gts


def _assert_map_equal(dets, gts, **kwargs):
    from cvnets_tpu.metrics.coco_map import compute_coco_map as jax_map
    from cvnets_tpu_torch.metrics.coco_map import compute_coco_map

    got, want = compute_coco_map(dets, gts, **kwargs), jax_map(dets, gts, **kwargs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


@pytest.mark.parametrize("seed", range(4))
def test_coco_map_equals_the_jax_map_on_random_detections(seed):
    dets, gts = _random_detections(np.random.default_rng(seed))
    _assert_map_equal(dets, gts)
    _assert_map_equal(dets, gts, max_dets=3)


def test_coco_map_equals_the_jax_map_on_the_golden_cases():
    import test_coco_map_golden as golden

    rng = np.random.default_rng(0)
    cases = [golden._rand_fixture(rng, tie_scores=True),
             golden._rand_fixture(rng, crowd_p=1.0),
             golden._rand_fixture(rng, size_spread=True, max_dt=60)]
    for dets, gts in cases:
        _assert_map_equal(dets, gts)
        _assert_map_equal(dets, gts, max_dets=10)


def test_coco_map_metric_gathers_and_refuses_segm():
    from cvnets_tpu_torch.metrics.coco_map import COCOMapMetric, compute_coco_map

    dets, gts = _random_detections(np.random.default_rng(9))
    metric = COCOMapMetric()
    for d, g in zip(dets, gts):
        metric.update(d, g)
    want = compute_coco_map(dets, gts)
    assert metric.compute() == {k: v * 100.0 for k, v in want.items()}
    with pytest.raises(NotImplementedError, match="item 10"):
        compute_coco_map(dets, gts, iou_type="segm")
