"""Mask R-CNN's parts in the PyTorch port against the JAX package, float32 on
the CPU, on seeded numpy inputs:

* ``roi_align`` (sampling ratios 1 and 2, 7×7 and 14×14, boxes running off
  the map) and ``multiscale_roi_align`` (four levels, tiny to huge boxes):
  values within 1e-5 of max(1, |value|), and the feature maps' grads of a
  seeded weighting within 1e-5 of the largest grad;
* ``paste_masks``: within 1e-5, zero outside each box;
* the R-CNN box coder: ``encode_boxes`` / ``decode_boxes`` within 1e-5 of
  max(1, |value|), the size clip included; ``fpn_anchors`` equal;
* ``match_boxes``: indices and labels equal, ties and padded gt included;
* ``balanced_sample_mask`` on JAX's own draws: the same masks, where many
  padded slots tie at 2.0; ``top_k_stable`` breaks ties as ``lax.top_k``;
* ``BlockConvTranspose`` / ``TransposeConvLayer2d`` (norm and activation,
  train and eval BN) and the FPN (levels of odd sizes: the nearest resize):
  outputs within 1e-5 of max(1, |value|), input and weight grads within 1e-5
  of the largest grad;
* ``MaskRCNNLoss``: the five weighted losses and the total within 1e-6; an
  eval-mode prediction's loss is a zero;
* ``rasterize_polygon``: the same pixels.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    assert_every_leaf_loaded,
    both_opts,
    flat_leaves,
    nchw,
    perturbed_variables,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _random_boxes(rng, n, size, min_side=1.0, max_side=None):
    max_side = max_side or size
    xy = rng.uniform(-4, size - 4, (n, 2))
    wh = rng.uniform(min_side, max_side, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("sampling,out", [(2, (7, 7)), (1, (14, 14)), (2, (28, 28))])
def test_roi_align_matches_jax_values_and_grads(sampling, out):
    from cvnets_tpu.ops.roi_align import roi_align as jax_roi_align
    from cvnets_tpu_torch.ops.roi_align import roi_align

    rng = np.random.default_rng(0)
    fm = rng.standard_normal((2, 13, 17, 6)).astype(np.float32)  # (B, H, W, C)
    boxes = np.stack([_random_boxes(rng, 5, 16, 0.5, 12) for _ in range(2)])
    w = rng.standard_normal((2, 5, *out, 6)).astype(np.float32)

    def jax_fn(f):
        o = jax.vmap(lambda a, b: jax_roi_align(a, b, out, sampling))(f, jnp.asarray(boxes))
        return jnp.sum(o * w), o

    (_, want), jgrad = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(fm))
    f = nchw(fm).requires_grad_()
    got = roi_align(f, torch.from_numpy(boxes), out, sampling)  # (B, N, C, oh, ow)
    (got * torch.from_numpy(w).permute(0, 1, 4, 2, 3)).sum().backward()
    _close(got.detach().permute(0, 1, 3, 4, 2).numpy(), want)
    g = np.asarray(jgrad)
    np.testing.assert_allclose(f.grad.permute(0, 2, 3, 1).numpy(), g, rtol=0,
                               atol=1e-5 * float(np.abs(g).max()))


def test_multiscale_roi_align_matches_jax_values_and_grads():
    from cvnets_tpu.ops.roi_align import multiscale_roi_align as jax_ms
    from cvnets_tpu_torch.ops.roi_align import fpn_levels, multiscale_roi_align

    rng = np.random.default_rng(1)
    strides, size = [4, 8, 16, 32], 128
    fms = [rng.standard_normal((2, size // s, size // s, 5)).astype(np.float32)
           for s in strides]
    # sides from 2 px to 4x the canonical 224, and one empty box: every level
    boxes = np.stack([np.concatenate([
        _random_boxes(rng, 3, size, 2, 40), _random_boxes(rng, 3, size, 60, 100),
        _random_boxes(rng, 2, size, 120, 200), _random_boxes(rng, 1, size, 300, 900),
        np.zeros((1, 4), np.float32)]) for _ in range(2)])
    levels = fpn_levels(torch.from_numpy(boxes), 4).numpy()
    assert set(levels.reshape(-1)) == {0, 1, 2, 3}
    w = rng.standard_normal((2, 10, 7, 7, 5)).astype(np.float32)

    def jax_fn(*f):
        o = jax.vmap(lambda *a: jax_ms(list(a[:-1]), a[-1], strides))(*f, jnp.asarray(boxes))
        return jnp.sum(o * w), o

    (_, want), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, fms))
    ts = [nchw(f).requires_grad_() for f in fms]
    got = multiscale_roi_align(ts, torch.from_numpy(boxes), strides)
    (got * torch.from_numpy(w).permute(0, 1, 4, 2, 3)).sum().backward()
    _close(got.detach().permute(0, 1, 3, 4, 2).numpy(), want)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jgrads)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g), rtol=0,
                                   atol=1e-5 * gmax)


def test_paste_masks_matches_jax():
    from cvnets_tpu.ops.mask_paste import paste_masks as jax_paste
    from cvnets_tpu_torch.ops.mask_paste import paste_masks

    rng = np.random.default_rng(2)
    masks = rng.uniform(size=(6, 28, 28)).astype(np.float32)
    boxes = _random_boxes(rng, 6, 60, 0.2, 50)  # some off the image, one under a pixel
    want = np.asarray(jax_paste(jnp.asarray(masks), jnp.asarray(boxes), (64, 80)))
    got = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), (64, 80)).numpy()
    _close(got, want)
    # batched over a leading image axis
    both = paste_masks(torch.from_numpy(masks).reshape(2, 3, 28, 28),
                       torch.from_numpy(boxes).reshape(2, 3, 4), (64, 80))
    np.testing.assert_array_equal(both.reshape(6, 64, 80).numpy(), got)


def test_box_coder_and_anchors_match_jax():
    from cvnets_tpu.models.detection.mask_rcnn import _fpn_anchors
    from cvnets_tpu.models.detection.utils import rcnn_utils as J
    from cvnets_tpu_torch.models.detection.mask_rcnn import fpn_anchors
    from cvnets_tpu_torch.models.detection.utils import rcnn_utils as T

    rng = np.random.default_rng(3)
    ref = _random_boxes(rng, 40, 100, 0.0, 60)  # zero-width boxes hit the 1e-4 floor
    ref[0, 2] = ref[0, 0]
    gt = _random_boxes(rng, 40, 100, 1.0, 60)
    deltas = rng.normal(0, 2.0, (40, 4)).astype(np.float32)
    deltas[:3, 2:] = 9.0  # past BBOX_XFORM_CLIP
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        _close(T.encode_boxes(torch.from_numpy(ref), torch.from_numpy(gt), weights).numpy(),
               J.encode_boxes(jnp.asarray(ref), jnp.asarray(gt), weights))
        _close(T.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(ref), weights).numpy(),
               J.decode_boxes(jnp.asarray(deltas), jnp.asarray(ref), weights))
    assert T.BBOX_XFORM_CLIP == J.BBOX_XFORM_CLIP
    shapes, strides = [(32, 24), (16, 12), (8, 6), (4, 3)], [4, 8, 16, 32]
    np.testing.assert_array_equal(fpn_anchors(shapes, strides, [32, 64, 128, 256]),
                                  _fpn_anchors(shapes, strides, [32, 64, 128, 256]))


def test_match_boxes_matches_jax():
    from cvnets_tpu.models.detection.utils.rcnn_utils import match_boxes as jax_match
    from cvnets_tpu_torch.models.detection.utils.rcnn_utils import match_boxes

    rng = np.random.default_rng(4)
    anchors = _random_boxes(rng, 300, 64, 4, 30)
    anchors[10] = anchors[11]  # two anchors tie for a gt's best IoU
    gt = np.zeros((2, 12, 4), np.float32)
    gt[:, :5] = np.stack([_random_boxes(rng, 5, 64, 6, 30) for _ in range(2)])
    gt[0, 0] = anchors[10] + 0.5
    valid = np.zeros((2, 12), bool)
    valid[:, :5] = True
    valid[1, 4] = False  # a padded slot with a box
    for high, low in ((0.7, 0.3), (0.5, 0.5)):
        idx, labels = match_boxes(torch.from_numpy(anchors), torch.from_numpy(gt),
                                  torch.from_numpy(valid), high, low)
        for b in range(2):
            j_idx, j_lab = jax_match(jnp.asarray(anchors), jnp.asarray(gt[b]),
                                     jnp.asarray(valid[b]), high, low)
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(j_idx))
            np.testing.assert_array_equal(labels[b].numpy(), np.asarray(j_lab))
    assert labels[0, 10] == labels[0, 11] == 1  # both forced


@pytest.mark.parametrize("num,frac", [(16, 0.25), (256, 0.5), (6, 0.5)])
def test_balanced_sample_mask_on_jax_draws(num, frac):
    from cvnets_tpu.models.detection.utils.rcnn_utils import balanced_sample_mask as jax_bsm
    from cvnets_tpu_torch.models.detection.utils.rcnn_utils import balanced_sample_mask

    rng = np.random.default_rng(5)
    labels = rng.choice([-1, 0, 1], size=(3, 400), p=[0.3, 0.6, 0.1])
    labels[2, :390] = -1  # few candidates: the targets are not met
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    for b in range(3):
        kp, kn = jax.random.split(keys[b])
        rp = np.array(jax.random.uniform(kp, (400,)))
        rn = np.array(jax.random.uniform(kn, (400,)))
        want = jax_bsm(keys[b], jnp.asarray(labels[b]), num, frac)
        got = balanced_sample_mask(torch.from_numpy(labels[b]), num, frac,
                                   torch.from_numpy(rp), torch.from_numpy(rn))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[0].sum() + got[1].sum()) <= num


def test_top_k_stable_breaks_ties_as_lax_top_k():
    from cvnets_tpu_torch.models.detection.utils.rcnn_utils import stable_rank, top_k_stable

    rng = np.random.default_rng(6)
    x = np.where(rng.random((4, 200)) < 0.7, -1.0, rng.random((4, 200))).astype(np.float32)
    x[:, 5:9] = 0.5
    vals, idx = top_k_stable(torch.from_numpy(x), 60)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 60)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(stable_rank(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.argsort(jnp.argsort(jnp.asarray(x)))))


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm_act", [False, True], ids=["plain", "norm_act"])
def test_transpose_conv_layer_matches_jax(norm_act, training):
    """``kernel[::-1, ::-1]`` inside each output block: an asymmetric kernel
    shows a wrong tap order."""
    from cvnets_tpu.layers.conv_layer import TransposeConvLayer2d as JaxLayer
    from cvnets_tpu_torch.layers.conv_layer import TransposeConvLayer2d
    from cvnets_tpu_torch.utils.jax_params import load_jax_params, to_torch_layout, torch_key

    opts_jax, opts_torch = both_opts(["--model.activation.name", "gelu"])
    x = np.random.default_rng(7).standard_normal((2, 5, 7, 6)).astype(np.float32)
    jm = JaxLayer(opts=opts_jax, out_channels=4, kernel_size=2, stride=2, bias=not norm_act,
                  use_norm=norm_act, use_act=norm_act)
    variables = perturbed_variables(jm, x)

    def fn(params, a):
        v = {**variables, "params": params}
        if training:
            return jm.apply(v, a, training=True, mutable=["batch_stats"])[0]
        return jm.apply(v, a, training=False)

    out = fn(variables["params"], jnp.asarray(x))
    jgrads = jax.grad(lambda p, a: jnp.sum(fn(p, a) ** 2), argnums=(0, 1))(
        variables["params"], jnp.asarray(x))
    layer = TransposeConvLayer2d(opts_torch, 6, 4, bias=not norm_act, use_norm=norm_act,
                                 use_act=norm_act)
    load_jax_params(layer, variables["params"], variables.get("batch_stats"))
    assert_every_leaf_loaded(layer, variables)
    t = nchw(x).requires_grad_()
    got = layer.train(training)(t)
    (got ** 2).sum().backward()
    _close(got.detach().permute(0, 2, 3, 1).numpy(), out)
    gmax = max(float(np.abs(g).max()) for g in
               [np.asarray(jgrads[1])] + [g for _, g in flat_leaves(jgrads[0])])
    np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgrads[1]),
                               rtol=0, atol=1e-5 * gmax)
    params = dict(layer.named_parameters())
    for path, g in flat_leaves(jgrads[0]):
        np.testing.assert_allclose(params[torch_key(path)].grad.numpy(), to_torch_layout(path, g),
                                   rtol=0, atol=1e-5 * gmax)


def test_fpn_matches_jax_at_odd_sizes():
    """Levels of 15×11, 8×6, 4×3, 2×2: the nearest upsampling picks JAX's
    source rows and columns where the sizes are not 2× apart."""
    from cvnets_tpu.modules.feature_pyramid import FeaturePyramidNetwork as JaxFPN
    from cvnets_tpu_torch.modules.feature_pyramid import FeaturePyramidNetwork
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, opts_torch = both_opts([])
    rng = np.random.default_rng(8)
    shapes = [(15, 11, 3), (8, 6, 5), (4, 3, 7), (2, 2, 9)]
    fms = [rng.standard_normal((2, *s)).astype(np.float32) for s in shapes]
    jm = JaxFPN(opts=opts_jax, out_channels=8)
    variables = jax.jit(lambda f: jm.init(jax.random.PRNGKey(0), f))(
        [jnp.asarray(f) for f in fms])
    variables = {c: jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05, t)
                 for c, t in variables.items()}
    want = jm.apply(variables, [jnp.asarray(f) for f in fms])
    fpn = FeaturePyramidNetwork(opts_torch, [s[-1] for s in shapes], 8)
    load_jax_params(fpn, variables["params"], variables.get("batch_stats"))
    with torch.no_grad():
        got = fpn.eval()([nchw(f) for f in fms])
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w)


def test_mask_rcnn_loss_matches_jax():
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu_torch.loss import build_loss_fn

    flags = ["--loss.category", "detection", "--loss.detection.name", "mask_rcnn_loss",
             "--loss.detection.mask-rcnn-loss.classifier-weight", "0.5",
             "--loss.detection.mask-rcnn-loss.box-reg-weight", "2",
             "--loss.detection.mask-rcnn-loss.mask-weight", "1.5",
             "--loss.detection.mask-rcnn-loss.objectness-weight", "0.25",
             "--loss.detection.mask-rcnn-loss.rpn-box-reg", "3"]
    opts_jax, opts_torch = both_opts(flags)
    values = {"loss_classifier": 1.25, "loss_box_reg": 0.5, "loss_mask": 0.75,
              "loss_objectness": 0.625, "loss_rpn_box_reg": 0.125}
    want = jax_loss(opts_jax)(None, {"losses": {k: jnp.asarray(v) for k, v in values.items()}},
                              None)
    crit = build_loss_fn(opts_torch, device="cpu")
    got = crit(None, {"losses": {k: torch.tensor(v) for k, v in values.items()}}, None)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    empty = crit(None, {"det_scores": torch.zeros(2, 3)}, None, training=False)
    assert list(empty) == ["total_loss"] and float(empty["total_loss"]) == 0.0


def test_rasterize_polygon_matches_jax():
    from cvnets_tpu.data.datasets.detection.coco_mask_rcnn import (
        rasterize_polygon as jax_rasterize,
    )
    from cvnets_tpu_torch.data.datasets.detection.coco_mask_rcnn import rasterize_polygon

    rng = np.random.default_rng(10)
    for _ in range(5):
        polys = [list(rng.uniform(-5, 45, 2 * k)) for k in (3, 7, 12)]
        np.testing.assert_array_equal(rasterize_polygon(polys, 37, 41),
                                      jax_rasterize(polys, 37, 41))
