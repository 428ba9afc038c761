"""Mask R-CNN's data path in the PyTorch port against the JAX package, on the
seeded COCO folder of ``cvnets_tpu_torch/tools/coco_corpus.py`` (polygons
with holes and several parts):

* ``coco_mask_rcnn`` items: where no flip, jitter or crop moves a sample
  (validation, and training samples drawn unflipped), the boxes, labels and
  masks equal JAX's and the pixels lie within one level of Pillow's;
* the JAX dataset's fault, pinned: it rasterizes the original polygons after
  transforms that move only the image and boxes. On a flipped sample the
  port's masks are JAX's mirrored, and lie inside their (flipped) boxes,
  where some of JAX's do not;
* Large Scale Jitter (``scale_jitter``, ``fixed_size_crop``, flip) on the
  same draws as JAX's transforms: boxes within 1e-4 px, labels equal, pixels
  within one level; a crop that drops a box drops its label and mask, every
  mask inside its box (the JAX dataset's item raises there);
* the corpus writer: its images and boxes are the parent's (the annotations
  without their segmentations hash as before), its polygons come from the
  seed;
* the ``segm`` COCO mAP against JAX's ``compute_coco_map`` on random
  detections and ground truth with masks, within 1e-12.
"""

from __future__ import annotations

import hashlib
import json
import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import both_opts  # noqa: E402

CROP = (96, 128)  # (h, w): the masks are 24 × 32
ARGS = ["--dataset.category", "detection", "--dataset.name", "coco_mask_rcnn",
        "--model.detection.name", "mask_rcnn", "--model.classification.name", "mobilenetv2"]
LSJ_ARGS = ARGS + ["--dataset.detection.coco-mask-rcnn.use-lsj-aug",
                   "--image-augmentation.scale-jitter.scale-range", "0.3", "2.0"]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from cvnets_tpu_torch.tools.coco_corpus import write_coco_corpus

    return write_coco_corpus(str(tmp_path_factory.mktemp("coco")), n_train=10, n_val=4,
                             max_side=120)


def _datasets(coco, training: bool, args=ARGS):
    from cvnets_tpu.data.datasets.detection.coco_mask_rcnn import COCOMaskRCNNDataset as Jax
    from cvnets_tpu_torch.data.datasets.detection.coco_mask_rcnn import COCOMaskRCNNDataset

    opts_jax, opts_torch = both_opts(args + ["--dataset.root-train", coco,
                                             "--dataset.root-val", coco])
    return Jax(opts_jax, is_training=training), COCOMaskRCNNDataset(opts_torch,
                                                                    is_training=training)


def _same_stream(monkeypatch, seed: int) -> None:
    """The JAX transforms' global ``random`` draws from ``random.Random(seed)``."""
    from cvnets_tpu.data.transforms import image, image_advanced

    rng = random.Random(seed)
    monkeypatch.setattr(image, "random", rng)
    monkeypatch.setattr(image_advanced, "random", rng)


def _items(jds, ds, idx: int, seed: int, monkeypatch):
    """(JAX item, port item, port params) of sample ``idx`` on one draw stream."""
    params = ds.draw_params((*CROP, idx), random.Random(seed))
    _same_stream(monkeypatch, seed)
    return jds[(*CROP, idx)], ds.get_item((*CROP, idx), params), params


def _pixels_close(got, want) -> None:
    diff = np.abs(got["samples"]["image"].permute(1, 2, 0).numpy().astype(np.float64)
                  - np.asarray(want["samples"]["image"], np.float64) * 255.0)
    assert diff.max() <= 1.0 + 1e-4


def _masks_inside_boxes(masks: np.ndarray, boxes: np.ndarray, labels: np.ndarray) -> list:
    """For each labelled instance, whether every mask pixel's center (at 4×)
    lies in its box, one pixel of slack."""
    out = []
    for m, b, lab in zip(masks, boxes, labels):
        if lab <= 0 or not m.any():
            continue
        ys, xs = np.nonzero(m)
        cx, cy = (xs + 0.5) * 4, (ys + 0.5) * 4
        out.append(bool((cx >= b[0] - 4).all() and (cx <= b[2] + 4).all()
                        and (cy >= b[1] - 4).all() and (cy <= b[3] + 4).all()))
    return out


@pytest.mark.parametrize("training", [False, True], ids=["val", "train"])
def test_unmoved_samples_equal_jax(coco, training, monkeypatch):
    jds, ds = _datasets(coco, training)
    assert ds.ids == jds.ids and ds.n_classes == jds.n_classes
    seen = 0
    for idx in range(len(ds)):
        want, got, params = _items(jds, ds, idx, 100 + idx, monkeypatch)
        if params is None or (training and params[-1]):
            continue  # the damaged file; a flipped sample
        seen += 1
        t, w = got["samples"]["targets"], want["targets"]
        np.testing.assert_array_equal(t["box_labels"].numpy(), w["box_labels"])
        np.testing.assert_array_equal(t["box_coordinates"].numpy(), w["box_coordinates"])
        np.testing.assert_array_equal(t["masks"].numpy(), w["masks"] > 0.5)
        assert t["masks"].dtype == torch.bool and tuple(t["masks"].shape) == (100, 24, 32)
        _pixels_close(got, want)
        assert got["targets"]["image_id"] == w["image_id"]
    assert seen >= 3


def test_flipped_masks_mirror_jax_and_stay_inside_their_boxes(coco, monkeypatch):
    jds, ds = _datasets(coco, training=True)
    flipped, jax_outside = 0, 0
    for seed in range(12):
        idx = seed % len(ds)
        want, got, params = _items(jds, ds, idx, seed, monkeypatch)
        if params is None or not params[-1]:
            continue
        flipped += 1
        t, w = got["samples"]["targets"], want["targets"]
        np.testing.assert_allclose(t["box_coordinates"].numpy(), w["box_coordinates"], atol=1e-4)
        np.testing.assert_array_equal(t["masks"].numpy(), (w["masks"] > 0.5)[..., ::-1])
        labels = t["box_labels"].numpy()
        assert all(_masks_inside_boxes(t["masks"].numpy(), w["box_coordinates"], labels))
        jax_outside += not all(_masks_inside_boxes(w["masks"] > 0.5, w["box_coordinates"],
                                                   labels))
    assert flipped >= 3 and jax_outside >= 1


@pytest.mark.parametrize("seed", range(4))
def test_lsj_matches_jax_draws_and_the_masks_follow(coco, seed, monkeypatch):
    from cvnets_tpu.data.transforms.image import RandomHorizontalFlip as JaxFlip
    from cvnets_tpu.data.transforms.image_advanced import FixedSizeCrop as JaxCrop
    from cvnets_tpu.data.transforms.image_advanced import ScaleJitter as JaxJitter

    jds, ds = _datasets(coco, training=True, args=LSJ_ARGS)
    opts_jax = jds.opts
    setattr(opts_jax, "image_augmentation.scale_jitter.target_size", [CROP[0], CROP[1]])
    chain = [JaxJitter(opts_jax), JaxCrop(opts_jax, size=list(CROP)), JaxFlip(opts_jax)]
    cropped = 0
    for idx in range(len(ds)):
        params = ds.draw_params((*CROP, idx), random.Random(seed * 100 + idx))
        if params is None:
            continue
        got = ds.get_item((*CROP, idx), params)
        image_id = ds.ids[idx]
        pil = jds.get_image(image_id)[0]
        boxes, labels, _ = jds.get_boxes_and_labels(image_id, *pil.size, include_masks=True)
        data = {"image": pil, "box_coordinates": boxes, "box_labels": labels}
        _same_stream(monkeypatch, seed * 100 + idx)
        for t in chain:
            data = t(data)
        n = len(data["box_labels"])
        t = got["samples"]["targets"]
        np.testing.assert_array_equal(t["box_labels"].numpy()[:n], data["box_labels"])
        assert (t["box_labels"].numpy()[n:] == 0).all()
        np.testing.assert_allclose(t["box_coordinates"].numpy()[:n],
                                   np.asarray(data["box_coordinates"]).reshape(-1, 4),
                                   rtol=0, atol=1e-4)
        diff = np.abs(got["samples"]["image"].permute(1, 2, 0).numpy().astype(np.int64)
                      - np.asarray(data["image"]).astype(np.int64))
        assert diff.max() <= 1
        if n < len(labels):  # JAX's item raises: its labels outnumber the kept boxes
            cropped += 1
            _same_stream(monkeypatch, seed * 100 + idx)
            with pytest.raises(ValueError, match="broadcast"):
                jds[(*CROP, idx)]
        assert all(_masks_inside_boxes(t["masks"].numpy(), t["box_coordinates"].numpy(),
                                       t["box_labels"].numpy()))
        assert t["masks"].numpy()[:n].any(axis=(1, 2)).sum() >= n - 1  # off-image parts
    if seed == 0:
        assert cropped >= 1  # a crop dropped a box (and its label and mask)


def test_corpus_keeps_its_images_and_boxes_and_draws_polygons_from_the_seed(tmp_path):
    from cvnets_tpu_torch.tools.coco_corpus import write_coco_corpus

    roots = [write_coco_corpus(str(tmp_path / name)) for name in ("a", "b")]
    blobs = [json.load(open(f"{r}/annotations/instances_train2017.json")) for r in roots]
    assert blobs[0] == blobs[1]
    segs = [a.pop("segmentation") for a in blobs[0]["annotations"]]
    assert {len(s) for s in segs} == {1, 2}
    # the parent writer's train annotations (seed 0, 12 + 6 images of up to 160 px)
    assert hashlib.sha256(json.dumps(blobs[0]).encode()).hexdigest() == (
        "96ac483b7de2096c3f78bd47f3cdb8ff3749b6aedd200749d7936246490aeea8")


def _random_masks(rng, n, h=24, w=32):
    masks = np.zeros((n, h, w), bool)
    for m in masks:
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        m[y:y + rng.integers(2, h - y + 1), x:x + rng.integers(2, w - x + 1)] = True
    return masks


@pytest.mark.parametrize("seed", range(3))
def test_segm_map_equals_the_jax_map(seed):
    from cvnets_tpu.metrics.coco_map import compute_coco_map as jax_map
    from cvnets_tpu_torch.metrics.coco_map import COCOMapMetric, compute_coco_map

    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(4):
        n_g, n_d = int(rng.integers(1, 5)), int(rng.integers(0, 8))
        gm = _random_masks(rng, n_g)
        gts.append({"boxes": rng.uniform(0, 30, (n_g, 4)), "labels": rng.integers(1, 4, n_g),
                    "masks": list(gm)})
        dm = np.concatenate([gm, _random_masks(rng, n_d)])[rng.permutation(n_g + n_d)]
        dm[:: 3] = np.roll(dm[:: 3], 1, axis=-1)  # some overlap partly
        dets.append({"boxes": rng.uniform(0, 30, (len(dm), 4)), "scores": rng.random(len(dm)),
                     "labels": rng.integers(1, 4, len(dm)), "masks": list(dm.astype(float))})
    want = jax_map(dets, gts, iou_type="segm")
    got = compute_coco_map(dets, gts, iou_type="segm")
    assert sorted(got) == sorted(want) and "segm_small" in got
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12, (k, got[k], v)
    metric = COCOMapMetric(both_opts(["--stats.coco-map.iou-types", "bbox", "segm"])[1])
    metric.update(dets, gts)
    out = metric.compute()
    assert abs(out["segm"] - 100 * want["segm"]) <= 1e-9 and "bbox" in out


def test_render_blends_kept_masks_and_draws_their_boxes():
    """The offline eval's drawing: a kept detection's mask (``> 0.5``) blended
    half and half with its class color, pixels outside every kept mask and
    box left as they are, a detection under the score threshold not drawn."""
    from cvnets_tpu_torch.engine.eval_detection import render_detections
    from cvnets_tpu_torch.models.detection import DetectionPredTuple
    from cvnets_tpu_torch.utils.color_map import Colormap

    image = np.full((40, 50, 3), 100, np.uint8)
    masks = np.zeros((2, 40, 50), np.float32)
    masks[0, 10:20, 10:30] = 0.9
    masks[1, 25:35, 5:15] = 0.9
    out = DetectionPredTuple(labels=np.array([2, 3]), scores=np.array([0.8, 0.1]),
                             boxes=np.array([[8.0, 8.0, 32.0, 22.0], [3.0, 23.0, 17.0, 37.0]]),
                             masks=masks)
    got = render_detections(image, out, score_threshold=0.3)
    color = np.asarray(Colormap().get_color_map()[2], np.float32)
    np.testing.assert_array_equal(got[15, 20], (0.5 * 100 + 0.5 * color).astype(np.uint8))
    np.testing.assert_array_equal(got[30, 10], [100, 100, 100])  # under the threshold
    np.testing.assert_array_equal(got[2, 2], [100, 100, 100])
    assert (got[8, 8:33] != 100).any()  # the kept box's outline
    np.testing.assert_array_equal(image, np.full((40, 50, 3), 100, np.uint8))  # not in place
