"""MobileNetV1, V2 and V3 (small and large) at narrow widths and EfficientNet-b0
in the PyTorch port against the JAX package on the same weights: 64 px,
batch 2, 13 classes, float32 on the CPU, stochastic depth 0. Eval and
train-mode logits, BN running statistics after one train forward, every
parameter grad of the label-smoothed CE in train and in eval mode, and every
loaded leaf. Tolerances are those of ``torch_port_helpers`` (LOGIT_ATOL, 2e-4
of a BN leaf's max, 5e-4 of the largest grad), except MobileNetV2-0.25's
train-mode grads in float32 (1e-2, below); with both sides in float64 they are
held at 5e-4.

MobileNetV1 and V2 give their classifier a dropout when the flag leaves it 0
(``min(0.1, 0.1·width)``, ``min(0.2, 0.2·width)``): the two packages draw
their dropout masks from different generators, so the train-mode cases build
both without it (the JAX package's ``bound_fn`` and the port's classifier
dropout set to 0), and a test of its own holds the value to JAX's."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    CONV_FAMILY_ARGS,
    assert_every_leaf_loaded,
    assert_grads_match,
    assert_logits_match,
    assert_loss_matches,
    assert_end_points_match,
    assert_stats_match,
    both_opts,
    float64_outputs,
    jax_leaf_shapes,
    jax_outputs,
    perturbed_variables,
    port_model_from,
    port_outputs,
    port_shapes,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """torch on two threads: the suite's xdist workers share the cores."""
    with torch_threads(2):
        yield

VARIANTS = {
    "mobilenetv1_0.25": ["--model.classification.name", "mobilenetv1",
                         "--model.classification.mobilenetv1.width-multiplier", "0.25",
                         "--model.activation.name", "relu"],
    "mobilenetv2_0.25": ["--model.classification.name", "mobilenetv2",
                         "--model.classification.mobilenetv2.width-multiplier", "0.25",
                         "--model.activation.name", "relu6"],
    "mobilenetv3_small_0.5": ["--model.classification.name", "mobilenetv3",
                              "--model.classification.mobilenetv3.mode", "small",
                              "--model.classification.mobilenetv3.width-multiplier", "0.5",
                              "--model.activation.name", "hard_swish"],
    "mobilenetv3_large_0.5": ["--model.classification.name", "mobilenetv3",
                              "--model.classification.mobilenetv3.mode", "large",
                              "--model.classification.mobilenetv3.width-multiplier", "0.5",
                              "--model.activation.name", "hard_swish"],
    "efficientnet_b0": ["--model.classification.name", "efficientnet",
                        "--model.classification.efficientnet.mode", "b0",
                        "--model.classification.efficientnet.stochastic-depth-prob", "0",
                        "--model.activation.name", "swish"],
}


def _args(variant):
    return VARIANTS[variant] + CONV_FAMILY_ARGS


def _no_classifier_dropout(model):
    model.classifier.dropout.p = 0.0


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    from cvnets_tpu.models import get_model
    from cvnets_tpu.utils import math_utils

    opts_jax, opts_torch = both_opts(_args(request.param))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = np.array([3, 11])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(math_utils, "bound_fn", lambda lo, hi, v: 0.0)
        jmodel = get_model(opts_jax)
        variables = perturbed_variables(jmodel, x)
        out = jax_outputs(jmodel, variables, x, y, opts_jax)
    return dict(variant=request.param, opts_torch=opts_torch, variables=variables,
                jax=out, port=port_outputs(opts_torch, variables, x, y,
                                           prepare=_no_classifier_dropout))


def test_eval_logits_match(pair):
    assert_logits_match(pair["port"]["eval"], pair["jax"]["eval"])


def test_train_logits_and_bn_stats_match(pair):
    assert_logits_match(pair["port"]["train"], pair["jax"]["train"])
    assert_stats_match(pair["port"]["state"], pair["jax"]["stats"])


# MobileNetV2 at width 0.25 (8-channel expansions into BN at batch 2) is chaotic
# in float32 in train mode: each package's grads lie 0.41% (JAX) and 0.36%
# (port) of the largest grad from a float64 run of the port, measured under
# this suite's XLA settings; the other variants' lie under 6e-5. So its
# train-mode grads are held at 1e-2, the rest at the stated 5e-4, and every
# eval-mode grad at 5e-4. In float64 on both sides
# (``test_train_mode_grads_match_in_float64``) they are held at 5e-4.
TRAIN_GRAD_REL = dict.fromkeys(VARIANTS, 5e-4) | {"mobilenetv2_0.25": 1e-2}


def test_loss_and_train_mode_grads_match(pair):
    assert_loss_matches(pair["port"]["loss"], pair["jax"]["loss"], pair["jax"]["train"])
    assert_grads_match(pair["port"]["grads"], pair["jax"]["grads"],
                       rel=TRAIN_GRAD_REL[pair["variant"]])


@pytest.mark.parametrize("variant", ["mobilenetv2_0.25"])
def test_train_mode_grads_match_in_float64(variant):
    """The batch-statistics BN backward through the inverted residuals at the
    stated 5e-4 of the largest grad, both packages in float64."""
    from cvnets_tpu.models import get_model
    from cvnets_tpu.utils import math_utils

    opts_jax, opts_torch = both_opts(_args(variant))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = np.array([3, 11])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(math_utils, "bound_fn", lambda lo, hi, v: 0.0)
        variables = perturbed_variables(get_model(opts_jax), x)
        want, got = float64_outputs(opts_jax, opts_torch, variables, x, y,
                                    prepare=_no_classifier_dropout)
    assert_logits_match(got["train"], want["train"])
    assert_stats_match(got["state"], want["stats"])
    assert_grads_match(got["grads"], want["grads"])


def test_eval_mode_grads_match(pair):
    assert_grads_match(pair["port"]["eval_grads"], pair["jax"]["eval_grads"])


def test_every_leaf_is_loaded(pair):
    assert_every_leaf_loaded(port_model_from(pair["opts_torch"], pair["variables"]),
                             pair["variables"])


@pytest.mark.parametrize("variant,width,want", [
    ("mobilenetv1", 1.0, 0.1), ("mobilenetv1", 0.25, 0.025),
    ("mobilenetv2", 1.0, 0.2), ("mobilenetv2", 0.5, 0.1)])
def test_default_classifier_dropout_is_the_jax_one(variant, width, want):
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model

    opts_jax, opts_torch = both_opts([
        "--model.classification.name", variant,
        f"--model.classification.{variant}.width-multiplier", str(width),
        *CONV_FAMILY_ARGS])
    jmodel = jax_model(opts_jax).bind({})
    jmodel.setup()
    assert jmodel.classifier.dropout == want
    assert get_model(opts_torch, device="cpu").classifier.dropout.p == want


@pytest.mark.parametrize("variant", ["mobilenetv1", "mobilenetv2", "mobilenetv3_small",
                                     "mobilenetv3_large", "efficientnet_b0",
                                     "efficientnet_b3"])
def test_full_width_parameter_shapes_are_the_jax_ones(variant):
    """At width 1.0 and 1,000 classes, every parameter and buffer of the port
    has the shape of the JAX model's leaf of its name."""
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model

    name, _, sub = variant.partition("_")
    args = ["--model.classification.name", name, "--dataset.category", "classification"]
    if name == "mobilenetv3":
        args += ["--model.classification.mobilenetv3.mode", sub]
    if name == "efficientnet":
        args += ["--model.classification.efficientnet.mode", sub]
    opts_jax, opts_torch = both_opts(args)
    want = jax_leaf_shapes(jax_model(opts_jax))
    assert port_shapes(get_model(opts_torch, device="cpu")) == want
    if variant == "mobilenetv2":  # the verify skill's zoo figure, 3.50M
        assert sum(int(np.prod(s)) for k, s in want.items() if "running" not in k) == 3_504_872


@pytest.mark.parametrize("variant,output_stride", [("mobilenetv2_0.25", 8),
                                                   ("mobilenetv3_small_0.5", 16)])
def test_output_stride_features_match(variant, output_stride):
    """The dilated encoders' tap points (DeepLabv3 on MobileNetV2 reads them)."""
    name = VARIANTS[variant][1]
    _, got = assert_end_points_match(_args(variant), name, output_stride)
    assert got["out_l5"].shape[-1] == got["out_l4"].shape[-1] == 64 // output_stride
