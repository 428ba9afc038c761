"""Mask R-CNN in the PyTorch port against the JAX package on the CPU, the
micro configuration of ``test_torch_mask_rcnn.py``:

* train mode in float64 on both sides, JAX's own draws (made in 64-bit mode)
  fed in: the five losses and the total within 1e-6 of max(1, |loss|) (both
  packages take the box, class and mask losses in float32, at the same
  points) and every parameter's grad within 1e-6 of the largest grad
  (float32 grads of a batch-statistics BN encoder at a perturbed init are
  0.4-2% off float64 in both packages, ``torch_port_helpers.float64_outputs``);
* ``--model.detection.mask-rcnn.disable-fpn`` with ``disable-mask-head``, and
  a head ``norm-layer``: the eval outputs of ``test_torch_mask_rcnn.py``.
"""

from __future__ import annotations

import sys

import jax
import numpy as np
import torch

sys.path.insert(0, "tests")

from torch_mask_rcnn_helpers import (  # noqa: E402
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
    flat_leaves,
    jax_in_float64,
    nchw,
    port_model_from,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


def test_train_losses_and_grads_match_jax_in_float64(monkeypatch):
    from cvnets_tpu.models import get_model
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    opts_jax, opts_torch, _, variables, x = build_micro()
    patch_jax_draws(monkeypatch)
    targets = micro_targets(2)
    with jax_in_float64(opts_jax):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        want, jgrads = jax_train_losses_and_grads(get_model(opts_jax), v64,
                                                  x.astype(np.float64), targets, opts_jax)
        draws = jax_draws(2, n_anchors(), 16 + 100)
    assert draws["rpn"].dtype == torch.float64
    model = port_model_from(opts_torch, variables).double().train()
    with torch_threads(2):
        pred = model({"image": nchw(x.astype(np.float64)), "targets": torch_targets(targets)},
                     draws=draws)
    got = build_loss_fn(opts_torch, device="cpu")(None, pred, None)
    for k, v in want.items():
        assert abs(got[k].item() - v) <= 1e-6 * max(1.0, abs(v)), (k, got[k].item(), v)
    got["total_loss"].backward()
    params = dict(model.named_parameters())
    leaves = list(flat_leaves(jgrads))
    assert len(leaves) == len(params)
    gmax = max(float(np.abs(g).max()) for _, g in leaves)
    for path, g in leaves:
        p = params[torch_key(path)]
        grad = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(grad, to_torch_layout(path, g), rtol=0, atol=1e-6 * gmax,
                                   err_msg=torch_key(path))


def test_variants_without_fpn_or_mask_head_and_with_head_norms_match_jax():
    """1×1 projections a tap (``proj_layers``) instead of the FPN, no mask
    head, BN in the RPN, box and mask heads' convs."""
    for extra in (["--model.detection.mask-rcnn.disable-fpn",
                   "--model.detection.mask-rcnn.disable-mask-head"],
                  ["--model.detection.mask-rcnn.norm-layer", "batch_norm"]):
        opts_jax, opts_torch, jmodel, variables, x = build_micro(extra)
        model = port_model_from(opts_torch, variables)
        assert_every_leaf_loaded(model, variables)
        got, _ = assert_eval_outputs_match(jmodel, variables, model, x)
        assert ("det_masks" in got) != ("disable-mask-head" in extra[-1])
