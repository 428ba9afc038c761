"""The ViT's simple FPN and Mask R-CNN on it, in the PyTorch port against the
JAX package on the CPU (float32, the micro ViT of
``torch_port_helpers.VIT_MICRO_ARGS`` with ``--model.classification.vit.use-simple-fpn``):

* the four taps (``out_l2`` … ``out_l5``: two transposed convs with BN and
  GELU between, one, the token map, its 2×2 max pool) in eval mode within
  ``LOGIT_ATOL`` of max(1, |value|), and in train mode (batch-statistics BN)
  with the same statistics within 2e-4;
* the positional table resampled from 196 to 4,096 positions (ViT-B/16's
  64 × 64 patches at 1024²) within 1e-6;
* Mask R-CNN on that ViT at 128² (S = 65 with the CLS token), the eval
  outputs of ``test_torch_mask_rcnn.py``; the JAX tree's ``encoder/classifier``
  (JAX's ViT computes logits it never uses there) has no counterpart in the
  port, whose detector drops the classifier.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, "tests")

from torch_mask_rcnn_helpers import MASK_RCNN_MICRO_ARGS, assert_eval_outputs_match  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    LOGIT_ATOL,
    VIT_MICRO_ARGS,
    assert_every_leaf_loaded,
    assert_stats_match,
    both_opts,
    nchw,
    perturbed_variables,
    port_model_from,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX
FPN_ARGS = VIT_MICRO_ARGS + ["--model.classification.vit.use-simple-fpn"]


def test_simple_fpn_taps_match_jax():
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(FPN_ARGS)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x, init_kwargs={
        "training": False, "return_image_embeddings": True})
    model = port_model_from(opts_torch, variables)
    assert_every_leaf_loaded(model, variables)
    taps = lambda m, a, t: m.extract_end_points_all(a, training=t)  # noqa: E731
    want = jmodel.apply(variables, jnp.asarray(x), False, method=taps)
    jtrain, new = jmodel.apply(variables, jnp.asarray(x), True, method=taps,
                               mutable=["batch_stats"])
    assert model.model_conf_dict["layer2"]["out"] == 16 and want["out_l2"].shape[-1] == 16
    with torch_threads(2), torch.no_grad():
        got = model.eval().extract_end_points_all(nchw(x))
        train = model.train().extract_end_points_all(nchw(x))
    for outs, ref in ((got, want), (train, jtrain)):
        assert sorted(outs) == ["out_l2", "out_l3", "out_l4", "out_l5"]
        for k, w in ref.items():
            w = np.asarray(w)
            np.testing.assert_allclose(outs[k].permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                       atol=LOGIT_ATOL * max(1.0, float(np.abs(w).max())),
                                       err_msg=k)
    assert tuple(got["out_l2"].shape[-2:]) == (16, 16) and tuple(got["out_l5"].shape[-2:]) == (2, 2)
    assert_stats_match(model.state_dict(), new["batch_stats"])


def test_positional_table_resamples_to_vit_b_at_1024_as_jax():
    from cvnets_tpu.layers.positional_embedding import interpolate_pos_embed as jax_resample
    from cvnets_tpu_torch.layers.positional_embedding import interpolate_pos_embed

    table = np.random.default_rng(1).standard_normal((196, 32)).astype(np.float32)
    want = np.asarray(jax_resample(jnp.asarray(table), 64 * 64))
    got = interpolate_pos_embed(torch.from_numpy(table), 64 * 64).numpy()
    assert got.shape == (4096, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mask_rcnn_on_the_simple_fpn_matches_jax():
    from cvnets_tpu.models import get_model

    args = [a for a in MASK_RCNN_MICRO_ARGS]
    i = args.index("mobilenetv2")
    args[i - 1:i + 3] = []  # the MobileNetV2 encoder and its width
    args += [a for a in FPN_ARGS if a not in ("--dataset.category", "classification")]
    opts_jax, opts_torch = both_opts(args)
    x = np.random.default_rng(2).standard_normal((2, 128, 128, 3)).astype(np.float32)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    assert "classifier" in variables["params"]["encoder"]
    port_vars = {col: {k: ({n: t for n, t in v.items() if n != "classifier"}
                           if k == "encoder" else v) for k, v in tree.items()}
                 for col, tree in variables.items()}
    model = port_model_from(opts_torch, port_vars)
    assert_every_leaf_loaded(model, port_vars)
    assert model.taps == ("out_l2", "out_l3", "out_l4", "out_l5")
    with torch_threads(2):
        assert_eval_outputs_match(jmodel, variables, model, x)
