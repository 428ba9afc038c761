"""The SSD building blocks of the PyTorch port against the JAX package, on the
CPU: the anchor generator (mobilevit.yaml's six strides and aspect ratios, at
320² and at a ragged size), the matcher (labels equal, locations within
1e-6, crowd-free boxes and an image with none), ``box_utils`` on numpy and
torch, and the padded NMS: the same kept indices and scores as the JAX scan,
with ties, an empty candidate set, ``max_output`` past N, and the class-aware
``batched_nms``, one image at a time and batched over images."""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import both_opts  # noqa: E402

SSD_ANCHOR_ARGS = [
    "--anchor-generator.name", "ssd", "--matcher.name", "ssd",
    "--anchor-generator.ssd.output-strides", "16", "32", "64", "128", "256", "-1",
    *sum((["--anchor-generator.ssd.aspect-ratios", "2", "3"] for _ in range(5)), []),
    "--anchor-generator.ssd.aspect-ratios", "2",
    "--anchor-generator.ssd.min-scale-ratio", "0.1",
    "--anchor-generator.ssd.max-scale-ratio", "1.05",
]


@pytest.fixture(scope="module")
def generators():
    from cvnets_tpu.models.anchor_generator import build_anchor_generator as jax_gen
    from cvnets_tpu.models.matcher_det import build_matcher as jax_matcher
    from cvnets_tpu_torch.models.anchor_generator import build_anchor_generator
    from cvnets_tpu_torch.models.matcher_det import build_matcher

    opts_jax, opts_torch = both_opts(SSD_ANCHOR_ARGS)
    return (jax_gen(opts_jax), build_anchor_generator(opts_torch),
            jax_matcher(opts_jax), build_matcher(opts_torch))


@pytest.mark.parametrize("size", [(320, 320), (427, 640), (37, 53)])
def test_anchors_are_the_jax_anchors(generators, size):
    from cvnets_tpu.data.datasets.detection.coco_ssd import COCOSSDDataset
    from cvnets_tpu_torch.models.detection.ssd import anchors_for

    jgen, gen, _, _ = generators
    assert gen.num_anchors_per_os() == jgen.num_anchors_per_os() == [6] * 5 + [4]
    want = COCOSSDDataset.generate_anchors(
        type("D", (), {"output_strides": jgen.output_strides,
                       "anchor_box_generator": jgen})(), *size)
    got = anchors_for(gen, *size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _random_boxes(rng, n, scale=1.0):
    xy = rng.random((n, 2)) * 0.8 * scale
    wh = (0.02 + rng.random((n, 2)) * 0.5) * scale
    return np.concatenate([xy, np.minimum(xy + wh, scale)], -1).astype(np.float32)


@pytest.mark.parametrize("n_boxes", [0, 1, 7])
def test_matcher_labels_and_locations_match(generators, n_boxes):
    from cvnets_tpu_torch.models.detection.ssd import anchors_for

    _, gen, jmatch, match = generators
    rng = np.random.default_rng(n_boxes)
    anchors = anchors_for(gen, 320, 320)
    boxes = _random_boxes(rng, n_boxes)
    labels = rng.integers(1, 81, n_boxes)
    want_loc, want_lab = jmatch(boxes, labels, anchors)
    got_loc, got_lab = match(boxes, labels, anchors)
    np.testing.assert_array_equal(got_lab, want_lab)
    np.testing.assert_allclose(got_loc, want_loc, rtol=0, atol=1e-6)
    assert (got_lab > 0).sum() >= min(n_boxes, 1) * (n_boxes > 0)
    # decoding the targets gives the matched boxes back
    dec = match.convert_to_boxes(torch.from_numpy(got_loc), torch.from_numpy(anchors))
    jdec = jmatch.convert_to_boxes(jnp.asarray(got_loc), jnp.asarray(anchors))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=0, atol=1e-6)


def test_box_utils_match_on_numpy_and_torch():
    from cvnets_tpu.ops import box_utils as jbu
    from cvnets_tpu_torch.ops import box_utils as bu

    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, 9), _random_boxes(rng, 5)
    for name in ("corner_to_center", "center_to_corner", "box_area"):
        want = getattr(jbu, name)(a)
        np.testing.assert_array_equal(getattr(bu, name)(a), want)
        np.testing.assert_allclose(getattr(bu, name)(torch.from_numpy(a)).numpy(), want,
                                   rtol=0, atol=1e-7)
    np.testing.assert_array_equal(bu.box_iou(a, b), jbu.box_iou(a, b))
    np.testing.assert_allclose(bu.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               jbu.box_iou(a, b), rtol=0, atol=1e-7)
    ca, cb = jbu.corner_to_center(a), jbu.corner_to_center(b[:1]).repeat(9, 0)
    loc = jbu.convert_boxes_to_locations(ca, cb)
    np.testing.assert_array_equal(bu.convert_boxes_to_locations(ca, cb), loc)
    np.testing.assert_allclose(bu.convert_locations_to_boxes(torch.from_numpy(loc),
                                                             torch.from_numpy(cb)).numpy(),
                               jbu.convert_locations_to_boxes(loc, cb), rtol=0, atol=1e-6)


def _nms_case(name: str):
    rng = np.random.default_rng(len(name))
    n = {"ties": 12, "empty": 6, "past_n": 5, "plain": 40}[name]
    boxes = _random_boxes(rng, n, scale=50.0)
    scores = rng.random(n).astype(np.float32)
    if name == "ties":
        boxes[6:] = boxes[:6]  # duplicate boxes with equal scores
        scores = np.round(scores * 4) / 4
        scores[6:] = scores[:6]
    if name == "empty":
        scores[:] = -np.inf
    labels = rng.integers(1, 4, n)
    return boxes, scores, labels


@pytest.mark.parametrize("case", ["plain", "ties", "empty", "past_n"])
@pytest.mark.parametrize("class_aware", [False, True])
def test_nms_keeps_what_the_jax_scan_keeps(case, class_aware):
    from cvnets_tpu.ops import nms as jnms
    from cvnets_tpu_torch.ops import nms

    boxes, scores, labels = _nms_case(case)
    max_output = 9 if case != "past_n" else 8  # past_n: more slots than boxes
    if class_aware:
        want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                                iou_threshold=0.4, max_output=max_output)
        got = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                              torch.from_numpy(labels), iou_threshold=0.4,
                              max_output=max_output)
    else:
        want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), iou_threshold=0.4,
                        max_output=max_output)
        got = nms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), iou_threshold=0.4,
                      max_output=max_output)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if case == "empty":
        assert (got[0] == -1).all()
    if case == "past_n":
        assert (got[0][len(boxes):] == -1).all()


def test_nms_batched_over_images_is_nms_of_each():
    from cvnets_tpu_torch.ops import nms

    cases = [_nms_case(c) for c in ("plain", "plain")]
    boxes = torch.from_numpy(np.stack([cases[0][0], cases[1][0][::-1].copy()]))
    scores = torch.from_numpy(np.stack([cases[0][1], cases[1][1][::-1].copy()]))
    labels = torch.from_numpy(np.stack([cases[0][2], cases[1][2][::-1].copy()]))
    keep, kept = nms.batched_nms(boxes, scores, labels, 0.4, 11)
    for i in range(2):
        one = nms.batched_nms(boxes[i], scores[i], labels[i], 0.4, 11)
        assert torch.equal(keep[i], one[0]) and torch.equal(kept[i], one[1])
