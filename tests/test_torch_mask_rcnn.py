"""Mask R-CNN in the PyTorch port against the JAX package on the CPU, at JAX's
test size (``torch_mask_rcnn_helpers.MASK_RCNN_MICRO_ARGS``: 128², a
MobileNetV2-0.25 encoder, an FPN of 32 channels, 5 classes, pre/post-NMS
64/16, 16 RoIs and 4 mask positives an image, 8 detections), batch 2, the
same perturbed weights on both sides (``utils/jax_params.py``):

* eval mode: the RPN's proposals, box scores and deltas within
  ``LOGIT_ATOL`` of max(1, their largest) (a proposal is exp(dw) times its
  anchor's size: the largest anchors scale the deltas' float32 noise),
  ``det_labels`` equal, ``det_scores`` within twice the scores' bound (a
  probability moves by at most twice its logits' largest move),
  ``det_boxes`` and ``det_masks`` within ``LOGIT_ATOL``; ``postprocess``'s
  pasted masks of image 0 as JAX's ``postprocess`` within 1e-4;
* train mode with JAX's own draws fed in: the five losses and the total in
  float32 within 1e-5 of max(1, |loss|) (their grads, in float64, and the
  variants' outputs: ``test_torch_mask_rcnn_float64.py``);
* the train step hands the model a generator seeded by (seed, step,
  ``DETECTION_STREAM``); the backbone's LR multiplier reaches the encoder's
  parameter groups only.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_mask_rcnn_helpers import (  # noqa: E402
    SIZE,
    assert_eval_outputs_match,
    build_micro,
    jax_draws,
    jax_train_losses_and_grads,
    micro_targets,
    n_anchors,
    patch_jax_draws,
    torch_targets,
)
from torch_port_helpers import (  # noqa: E402
    assert_every_leaf_loaded,
    nchw,
    port_model_from,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def micro():
    return build_micro()


def test_every_flax_leaf_loads(micro):
    opts_jax, opts_torch, jmodel, variables, x = micro
    assert_every_leaf_loaded(port_model_from(opts_torch, variables), variables)


def test_eval_outputs_and_pasted_masks_match_jax(micro):
    opts_jax, opts_torch, jmodel, variables, x = micro
    model = port_model_from(opts_torch, variables)
    got, want = assert_eval_outputs_match(jmodel, variables, model, x)
    post = model.postprocess(got)
    jpost = jmodel.postprocess(want)  # image 0, JAX's paste
    assert tuple(post.masks.shape) == (2, 8, SIZE, SIZE)
    np.testing.assert_allclose(post.masks[0].numpy(), np.asarray(jpost.masks), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(post.labels[0].numpy(), np.asarray(jpost.labels))


def test_train_losses_match_jax_on_its_draws(micro, monkeypatch):
    opts_jax, opts_torch, jmodel, variables, x = micro
    patch_jax_draws(monkeypatch)
    targets = micro_targets(2)
    want, _ = jax_train_losses_and_grads(jmodel, variables, x, targets, opts_jax)
    from cvnets_tpu_torch.loss import build_loss_fn

    model = port_model_from(opts_torch, variables).train()
    pred = model({"image": nchw(x), "targets": torch_targets(targets)},
                 draws=jax_draws(2, n_anchors(), 16 + 100))
    got = build_loss_fn(opts_torch, device="cpu")(None, pred, None)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k].item() - v) <= 1e-5 * max(1.0, abs(v)), (k, got[k].item(), v)


def test_train_step_draws_from_the_step_generator_and_multiplies_the_backbone_lr(micro):
    from cvnets_tpu_torch.engine.train_state import (
        DETECTION_STREAM,
        create_train_state,
        make_train_step,
        step_generator,
    )
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.optim import build_optimizer

    _, opts_torch, _, variables, x = micro
    setattr(opts_torch, "model.detection.mask_rcnn.backbone_lr_multiplier", 0.7)
    targets = torch_targets(micro_targets(2))
    batch = {"samples": {"image": nchw(x), "targets": targets}, "targets": {}}
    losses = []
    for _ in range(2):
        model = port_model_from(opts_torch, variables)
        assert model.get_lr_multipliers(opts_torch) == {"encoder": 0.7}
        opt = build_optimizer(opts_torch, model, model.get_lr_multipliers(opts_torch))
        names = {id(p): n for n, p in model.named_parameters()}
        for group in opt.param_groups:
            assert all(names[id(p)].startswith("encoder.") == (group["lr_mult"] == 0.7)
                       for p in group["params"])
        state = create_train_state(model, opt)
        crit = build_loss_fn(opts_torch, device="cpu")
        step = make_train_step(model, crit, opts_torch, build_metrics(opts_torch, ["loss"]))
        state.step = 5
        _, metrics = step(state, batch, lr=0.0)
        losses.append(metrics["loss"]["loss"][0].item())
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    # the step's loss is the forward's on the draws of (seed, 5, DETECTION_STREAM)
    model = port_model_from(opts_torch, variables).train()
    gen = step_generator({}, torch.device("cpu"), getattr(opts_torch, "common.seed", 0) or 0, 5,
                         DETECTION_STREAM)
    pred = model(batch["samples"], generator=gen)
    want = build_loss_fn(opts_torch, device="cpu")(None, pred, None)["total_loss"].item()
    assert abs(want - losses[0]) <= 1e-6 * max(1.0, abs(want))
