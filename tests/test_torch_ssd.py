"""SSDLite in the PyTorch port against the JAX package, float32 on the CPU: the
detection yaml's strides (16 … 256 and the pooled -1), aspect ratios and
head layout on a MobileViTv1 ``xx_small`` encoder, 6 classes, projections cut
to 32-64 channels, at 128 px, batch 2, the same perturbed weights on both
sides (through ``utils/jax_params.py``), targets matched from random boxes:

* eval and train outputs (scores, boxes, anchors) to the conv families'
  LOGIT_ATOL of max(1, the largest value), BN statistics to 2e-4;
* ``SSDLoss`` (hard negatives at ratio 3), on the port model's outputs and
  on JAX's, within 1e-5 of its largest term (the larger of its CE and
  smooth-L1 sums over the positives, in the loss's units), and the
  parameter grads of train and eval mode to 5e-4 of the largest;
* ``predict``: the same labels, and kept scores and boxes within 1e-5, as
  JAX's ``postprocess`` of each image (the port runs both images at once);
* hard-negative mining picks the JAX anchors where background losses tie;
* ``use_fpn`` and Mask R-CNN on a dilated ViT raise, naming ROADMAP.md item 5.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from test_torch_detection_ops import SSD_ANCHOR_ARGS, _random_boxes  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    LOGIT_ATOL,
    assert_every_leaf_loaded,
    assert_grads_match,
    assert_stats_match,
    both_opts,
    nchw,
    perturbed_variables,
    port_model_from,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

SSD_MICRO_ARGS = SSD_ANCHOR_ARGS + [
    "--dataset.category", "detection",
    "--model.detection.name", "ssd",
    "--model.detection.n-classes", "6",
    "--model.detection.ssd.proj-channels", "64", "48", "48", "32", "32", "32",
    "--model.classification.name", "mobilevit",
    "--model.classification.mit.mode", "xx_small",
    "--model.activation.name", "swish",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "detection",
    "--loss.detection.name", "ssd_multibox_loss",
    "--loss.detection.ssd-multibox-loss.neg-pos-ratio", "3",
]
SIZE = 128


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def matched_targets(opts_torch, batch: int, size: int, seed: int = 0):
    from cvnets_tpu_torch.models.detection.ssd import anchor_generator_and_matcher, anchors_for

    gen, matcher = anchor_generator_and_matcher(opts_torch)
    anchors = anchors_for(gen, size, size)
    rng = np.random.default_rng(seed)
    locs, labels = zip(*(matcher(_random_boxes(rng, 3), rng.integers(1, 6, 3), anchors)
                         for _ in range(batch)))
    return np.stack(locs), np.stack(labels)


@pytest.fixture(scope="module")
def pair():
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu.models import get_model
    from cvnets_tpu_torch.loss import build_loss_fn

    opts_jax, opts_torch = both_opts(SSD_MICRO_ARGS)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    locs, labels = matched_targets(opts_torch, 2, SIZE)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    jcrit, crit = jax_loss(opts_jax), build_loss_fn(opts_torch)
    xj = jnp.asarray(x)
    jtarget = {"box_labels": jnp.asarray(labels), "box_coordinates": jnp.asarray(locs)}
    target = {"box_labels": torch.from_numpy(labels), "box_coordinates": torch.from_numpy(locs)}

    def loss_fn(params, training):
        kw = dict(mutable=["batch_stats"]) if training else {}
        out = jmodel.apply({**variables, "params": params}, xj, training=training, **kw)
        pred, new = out if training else (out, {})
        return jcrit(xj, pred, jtarget), (pred, new)

    want = {}
    for mode in ("train", "eval"):
        (loss, (pred, new)), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, mode == "train"), has_aux=True))(variables["params"])
        want[mode] = dict(loss=float(loss), pred=jax.tree_util.tree_map(np.asarray, pred),
                          grads=jax.tree_util.tree_map(np.asarray, grads),
                          stats=jax.tree_util.tree_map(np.asarray, new.get("batch_stats", {})))
    predict = jax.jit(lambda v, a: jmodel.apply(v, a, method=lambda m, b: m.predict(b)))
    want["post"] = [jax.tree_util.tree_map(np.asarray, predict(variables, xj[i:i + 1]))
                    for i in range(2)]

    got = {}
    for mode in ("train", "eval"):
        model = port_model_from(opts_torch, variables).train(mode == "train")
        pred = model(nchw(x))
        loss = crit(None, pred, target, training=True)
        loss.backward()
        got[mode] = dict(loss=loss.item(), pred={k: v.detach().numpy() for k, v in pred.items()},
                         grads={k: p.grad for k, p in model.named_parameters()},
                         state=model.state_dict(), model=model)
    return dict(want=want, got=got, x=x, variables=variables, opts_torch=opts_torch,
                labels=labels, locs=locs)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_ATOL * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_outputs_match(pair, mode):
    got, want = pair["got"][mode]["pred"], pair["want"][mode]["pred"]
    assert sorted(got) == sorted(want) == ["anchors", "boxes", "scores"]
    n_anchors = 8 * 8 * 6 + 4 * 4 * 6 + 2 * 2 * 6 + 6 + 6 + 4
    assert got["scores"].shape == (2, n_anchors, 6) and got["boxes"].shape == (2, n_anchors, 4)
    np.testing.assert_array_equal(got["anchors"], want["anchors"])
    for key in ("scores", "boxes"):
        _close(got[key], want[key], key)


def test_bn_stats_match(pair):
    assert_stats_match(pair["got"]["train"]["state"], pair["want"]["train"]["stats"])


def largest_term(pred, labels, locs, loss) -> float:
    """The larger of the loss's two sums (the smooth-L1 over the positives and
    the CE over the positives and the mined negatives) and 1, in the loss's
    own units (over the number of positives); the CE sum is what is left of
    ``loss`` times the positives."""
    pos = labels > 0
    d = np.abs(pred["boxes"].astype(np.float64) - locs)
    l1 = np.where(d < 1.0, 0.5 * d ** 2, d - 0.5).sum(-1)[pos].sum()
    n = int(pos.sum())
    return max(1.0, loss * n - l1, l1) / n


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_loss_and_grads_match(pair, mode):
    from cvnets_tpu_torch.loss import build_loss_fn

    got, want = pair["got"][mode], pair["want"][mode]
    labels, locs = pair["labels"], pair["locs"]
    assert (labels > 0).sum() >= 2
    bound = 1e-5 * largest_term(want["pred"], labels, locs, want["loss"])
    # the port's loss of JAX's outputs, and the port model's loss
    target = {"box_labels": torch.from_numpy(labels), "box_coordinates": torch.from_numpy(locs)}
    same = build_loss_fn(pair["opts_torch"])(
        None, {k: torch.from_numpy(np.array(v)) for k, v in want["pred"].items()}, target,
        training=True).item()
    assert abs(same - want["loss"]) <= bound
    assert abs(got["loss"] - want["loss"]) <= bound
    assert_grads_match(got["grads"], want["grads"])


def test_every_leaf_is_loaded(pair):
    model = pair["got"]["eval"]["model"]
    assert_every_leaf_loaded(model, pair["variables"])
    assert model.encoder.classifier is None and model.encoder.conv_1x1_exp is None


def test_predict_keeps_the_jax_boxes(pair):
    model = pair["got"]["eval"]["model"]
    out = model.predict(nchw(pair["x"]))
    for i, want in enumerate(pair["want"]["post"]):
        k = int((np.asarray(want.scores) > 0).sum())
        assert k > 3
        np.testing.assert_array_equal(out.labels[i].numpy(), np.asarray(want.labels))
        np.testing.assert_allclose(out.scores[i].numpy(), np.asarray(want.scores), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(out.boxes[i].numpy(), np.asarray(want.boxes), rtol=0,
                                   atol=1e-5)


def test_hard_negatives_break_ties_as_jax():
    """Every background loss equal: the stable sort keeps the lowest anchors."""
    from cvnets_tpu.loss.detection import SSDLoss as JaxSSDLoss
    from cvnets_tpu_torch.loss.detection import SSDLoss

    opts_jax, opts_torch = both_opts(SSD_MICRO_ARGS)
    rng = np.random.default_rng(3)
    scores = np.zeros((2, 50, 6), np.float32)
    scores[..., 1:] = rng.standard_normal((2, 50, 5)).astype(np.float32) * 0.0
    scores[0, :, 0] = np.repeat(rng.standard_normal(10), 5)  # ties in fives
    labels = np.zeros((2, 50), np.int64)
    labels[0, [3, 17]] = 2
    labels[1, [40]] = 4
    locs = rng.standard_normal((2, 50, 4)).astype(np.float32)
    boxes = rng.standard_normal((2, 50, 4)).astype(np.float32)
    want = JaxSSDLoss(opts_jax)(None, {"scores": jnp.asarray(scores), "boxes": jnp.asarray(boxes)},
                                {"box_labels": jnp.asarray(labels),
                                 "box_coordinates": jnp.asarray(locs)})
    scores_t = torch.from_numpy(scores).requires_grad_()
    got = SSDLoss(opts_torch)(None, {"scores": scores_t, "boxes": torch.from_numpy(boxes)},
                              {"box_labels": torch.from_numpy(labels),
                               "box_coordinates": torch.from_numpy(locs)})
    assert abs(got.item() - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    got.backward()
    # the CE reaches exactly the positives and the chosen negatives
    chosen = (scores_t.grad.abs().sum(-1) > 0).numpy()
    jgrad = jax.grad(lambda s: JaxSSDLoss(opts_jax)(
        None, {"scores": s, "boxes": jnp.asarray(boxes)},
        {"box_labels": jnp.asarray(labels), "box_coordinates": jnp.asarray(locs)}))(
        jnp.asarray(scores))
    np.testing.assert_array_equal(chosen, np.abs(np.asarray(jgrad)).sum(-1) > 0)
    assert chosen[0].sum() == 2 + 6 and chosen[1].sum() == 1 + 3


@pytest.mark.parametrize("flags, item", [
    (["--model.detection.ssd.use-fpn"], "item 5"),
    # Mask R-CNN is ported: on a dilated ViT (a segmentation-style encoder) it
    # raises, naming the ViT's item
    (["--model.detection.name", "mask_rcnn", "--model.detection.output-stride", "8",
      "--model.classification.name", "vit", "--model.classification.vit.mode", "micro"],
     "item 5")])
def test_unported_detection_parts_raise(flags, item):
    from cvnets_tpu_torch.models import get_model

    _, opts_torch = both_opts(SSD_MICRO_ARGS + flags)
    with pytest.raises(NotImplementedError, match=item):
        get_model(opts_torch, device="cpu")
