"""What the Mask R-CNN parity tests share: the micro configuration (JAX's test
size: 128², MobileNetV2-0.25, pre/post-NMS 64/16, 16 RoIs and 4 mask
positives an image), JAX's own random draws made outside its model, and the
JAX model's forward with those draws.

The JAX model draws from ``make_rng("dropout")``: the tests patch it to
return a fixed key, make JAX's draws from that key as its model does
(``fold_in`` 1 for the RPN, 2 for the RoI heads, ``split`` by image, then
``split`` for the positives' and negatives' uniforms and ``fold_in`` 7 for
the compaction's), and give the same draws to the port's forward
(``draws=``)."""

from __future__ import annotations

import numpy as np

MASK_RCNN_MICRO_ARGS = [
    "--dataset.category", "detection",
    "--model.detection.name", "mask_rcnn",
    "--model.detection.n-classes", "5",
    "--model.classification.name", "mobilenetv2",
    "--model.classification.mobilenetv2.width-multiplier", "0.25",
    "--model.detection.mask-rcnn.pre-nms-top-n", "64",
    "--model.detection.mask-rcnn.post-nms-top-n", "16",
    "--model.detection.mask-rcnn.box-batch-per-image", "16",
    "--model.detection.mask-rcnn.mask-positives", "4",
    "--model.detection.mask-rcnn.detections-per-image", "8",
    "--model.detection.mask-rcnn.fpn-out-channels", "32",
    "--loss.category", "detection",
    "--loss.detection.name", "mask_rcnn_loss",
]
SIZE = 128
DRAW_KEY = 42


def n_anchors(size: int = SIZE, strides=(4, 8, 16, 32)) -> int:
    return sum((size // s) ** 2 * 3 for s in strides)


def jax_draws(batch: int, n_anchor: int, n_cand: int, key: int = DRAW_KEY) -> dict:
    """The JAX model's uniform draws of one training forward from
    ``PRNGKey(key)``, as the port's ``draws``: {"rpn": (2, B, A), "roi": (3,
    B, N)}. In 64-bit mode (``jax.enable_x64``) they are JAX's float64 draws."""
    import jax
    import torch

    root = jax.random.PRNGKey(key)
    rpn, roi = [[], []], [[], [], []]
    for k in jax.random.split(jax.random.fold_in(root, 1), batch):
        kp, kn = jax.random.split(k)
        rpn[0].append(jax.random.uniform(kp, (n_anchor,)))
        rpn[1].append(jax.random.uniform(kn, (n_anchor,)))
    for k in jax.random.split(jax.random.fold_in(root, 2), batch):
        kp, kn = jax.random.split(k)
        roi[0].append(jax.random.uniform(kp, (n_cand,)))
        roi[1].append(jax.random.uniform(kn, (n_cand,)))
        roi[2].append(jax.random.uniform(jax.random.fold_in(k, 7), (n_cand,)))

    def stack(parts):
        return torch.from_numpy(np.stack([np.stack([np.asarray(a) for a in p]) for p in parts]))

    return {"rpn": stack(rpn), "roi": stack(roi)}


def patch_jax_draws(monkeypatch, key: int = DRAW_KEY) -> None:
    """The JAX model's ``make_rng`` returns ``PRNGKey(key)``."""
    import jax

    from cvnets_tpu.models.detection.mask_rcnn import MaskRCNNDetector

    monkeypatch.setattr(MaskRCNNDetector, "make_rng",
                        lambda self, name: jax.random.PRNGKey(key), raising=False)


def micro_targets(batch: int, size: int = SIZE, seed: int = 0) -> dict:
    """JAX's ``dummy_input_and_label`` targets: 4 boxes an image padded to
    MAX_GT, random labels, random binary masks at 1/4 resolution."""
    from cvnets_tpu.models.detection.mask_rcnn import MAX_GT

    rng = np.random.default_rng(seed)
    boxes = np.zeros((batch, MAX_GT, 4), np.float32)
    labels = np.zeros((batch, MAX_GT), np.int64)
    for bi in range(batch):
        for gi in range(4):
            x1, y1 = rng.uniform(0, size // 2, 2)
            bw, bh = rng.uniform(8, size // 2, 2)
            boxes[bi, gi] = [x1, y1, min(x1 + bw, size - 1), min(y1 + bh, size - 1)]
            labels[bi, gi] = rng.integers(1, 5)
    masks = rng.uniform(size=(batch, MAX_GT, size // 4, size // 4)) > 0.5
    return {"box_coordinates": boxes, "box_labels": labels, "masks": masks}


def torch_targets(targets: dict) -> dict:
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in targets.items()}


def jax_train_losses_and_grads(jmodel, variables: dict, x: np.ndarray, targets: dict,
                               opts_jax) -> tuple:
    """The JAX model's five losses and total, and the total's parameter grads,
    in one training forward on ``x`` (NHWC) with ``targets`` (numpy)."""
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.loss import build_loss_fn

    crit = build_loss_fn(opts_jax)
    samples = {"image": jnp.asarray(x),
               "targets": {k: jnp.asarray(np.asarray(v, np.float32) if k == "masks" else v)
                           for k, v in targets.items()}}

    def loss_fn(params):
        pred, _ = jmodel.apply({**variables, "params": params}, samples, training=True,
                               mutable=["batch_stats"])
        losses = crit(None, pred, None)
        return losses["total_loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def build_micro(extra=()):
    """(opts_jax, opts_torch, JAX model, perturbed variables, x (2, 128, 128, 3))
    of the micro configuration plus ``extra`` flags."""
    from cvnets_tpu.models import get_model
    from torch_port_helpers import both_opts, perturbed_variables

    opts_jax, opts_torch = both_opts(MASK_RCNN_MICRO_ARGS + list(extra))
    x = np.random.default_rng(0).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    return opts_jax, opts_torch, jmodel, variables, x


def assert_eval_outputs_match(jmodel, variables, model, x):
    """The eval outputs of the port's ``model`` against the JAX model's (the
    tolerances of ``test_torch_mask_rcnn.py``); returns both."""
    import jax
    import jax.numpy as jnp
    import torch

    from torch_port_helpers import LOGIT_ATOL, nchw

    want = jax.jit(lambda v, a: jmodel.apply(v, a, training=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(nchw(x))
    g = {k: v.numpy() for k, v in got.items() if isinstance(v, torch.Tensor)}
    w = {k: np.asarray(v) for k, v in want.items() if k != "image_hw"}
    assert sorted(g) == sorted(w)

    def close(key, tol):
        np.testing.assert_allclose(g[key], w[key], rtol=0, err_msg=key,
                                   atol=tol * max(1.0, float(np.abs(w[key]).max())))

    close("proposals", LOGIT_ATOL)  # exp(dw) · w: a large anchor scales its deltas' noise
    close("scores", LOGIT_ATOL)
    close("deltas", LOGIT_ATOL)
    np.testing.assert_array_equal(g["det_labels"], w["det_labels"])
    # a softmax probability moves by at most twice its logits' largest move
    np.testing.assert_allclose(g["det_scores"], w["det_scores"], rtol=0, err_msg="det_scores",
                               atol=2 * LOGIT_ATOL * max(1.0, float(np.abs(w["scores"]).max())))
    close("det_boxes", LOGIT_ATOL)
    if "det_masks" in w:
        close("det_masks", LOGIT_ATOL)
    assert (w["det_scores"] > 0).sum() > 0  # some detection survives
    return got, want
