"""ResNet in the PyTorch port against the JAX package on the same weights:
ResNet-18 (basic blocks) and ResNet-50 (bottlenecks), each with and without SE,
at 64 px, batch 2 and 13 classes, float32 on the CPU. Eval and train-mode
logits, BN running statistics after one train forward, every parameter grad
of the label-smoothed CE in train and in eval mode, and every loaded leaf.
Tolerances are those of ``torch_port_helpers`` (LOGIT_ATOL, 2e-4 of a BN
leaf's max, 5e-4 of the largest grad) unless a test states its own; the
train-mode grads of ResNet-50 are held at 5e-4 again with both sides in
float64. The output strides, the SGD trajectory and stochastic depth are in
test_torch_resnet_train.py."""

from __future__ import annotations

import functools
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
    assert_stats_match,
    both_opts,
    float64_outputs,
    jax_outputs,
    perturbed_variables,
    port_model_from,
    port_outputs,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """torch on two threads: the suite's xdist workers share the cores."""
    with torch_threads(2):
        yield

VARIANTS = {
    "resnet18": ["--model.classification.resnet.depth", "18"],
    "se_resnet18": ["--model.classification.resnet.depth", "18",
                    "--model.classification.resnet.se-resnet"],
    "resnet50": ["--model.classification.resnet.depth", "50"],
    "se_resnet50": ["--model.classification.resnet.depth", "50",
                    "--model.classification.resnet.se-resnet"],
}


def _args(variant):
    return ["--model.classification.name", "resnet", "--model.activation.name", "relu",
            *VARIANTS[variant], *CONV_FAMILY_ARGS]


@functools.cache
def _inputs(variant):
    """The batch, its labels and the perturbed flax variables of ``variant``
    (numpy, shared read-only by the float32 and the float64 cases)."""
    from cvnets_tpu.models import get_model

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    return x, np.array([3, 11]), perturbed_variables(get_model(both_opts(_args(variant))[0]), x)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(_args(request.param))
    x, y, variables = _inputs(request.param)
    jmodel = get_model(opts_jax)
    return dict(variant=request.param, opts_torch=opts_torch, variables=variables,
                jax=jax_outputs(jmodel, variables, x, y, opts_jax),
                port=port_outputs(opts_torch, variables, x, y))


def test_eval_logits_match(pair):
    assert_logits_match(pair["port"]["eval"], pair["jax"]["eval"])


def test_train_logits_and_bn_stats_match(pair):
    assert_logits_match(pair["port"]["train"], pair["jax"]["train"])
    assert_stats_match(pair["port"]["state"], pair["jax"]["stats"])


# Train-mode grads of ResNet-50 at this init are chaotic in float32: each
# package's lie 1.5-2.1% of the largest grad from a float64 run of the port
# (measured under this suite's XLA settings: resnet50 JAX 2.1%, port 2.1%;
# se_resnet50 1.5% and 1.6%), from batch-statistic BN through 16 bottlenecks,
# while ResNet-18's agree to 5e-6 and every eval-mode (running-statistics) grad
# to 2e-6. So in float32 ResNet-50's train-mode grads are held at 5e-2 of the
# largest grad, and every variant's eval-mode grads at the stated 5e-4; with
# both sides in float64 (``test_train_mode_grads_match_in_float64``) the chaos
# goes and ResNet-50's train-mode grads are held at 5e-4 (they agree to 4e-8).
TRAIN_GRAD_REL = {"resnet18": 5e-4, "se_resnet18": 5e-4, "resnet50": 5e-2,
                  "se_resnet50": 5e-2}


def test_loss_and_train_mode_grads_match(pair):
    assert_loss_matches(pair["port"]["loss"], pair["jax"]["loss"], pair["jax"]["train"])
    assert_grads_match(pair["port"]["grads"], pair["jax"]["grads"],
                       rel=TRAIN_GRAD_REL[pair["variant"]])


@pytest.mark.parametrize("variant", ["resnet50", "se_resnet50"])
def test_train_mode_grads_match_in_float64(variant):
    """The batch-statistics BN backward through every bottleneck (and SE) at
    the stated 5e-4 of the largest grad, both packages in float64."""
    opts_jax, opts_torch = both_opts(_args(variant))
    x, y, variables = _inputs(variant)
    want, got = float64_outputs(opts_jax, opts_torch, variables, x, y)
    assert_logits_match(got["train"], want["train"])
    assert_stats_match(got["state"], want["stats"])
    assert_grads_match(got["grads"], want["grads"])


def test_eval_mode_grads_match(pair):
    assert_grads_match(pair["port"]["eval_grads"], pair["jax"]["eval_grads"])


def test_every_leaf_is_loaded_and_the_shapes_are_the_reference(pair):
    model = port_model_from(pair["opts_torch"], pair["variables"])
    assert_every_leaf_loaded(model, pair["variables"])
    blocks = {"resnet18": 8, "resnet50": 16}[pair["variant"].replace("se_", "")]
    assert sum(len(getattr(model, f"layer_{i}")) for i in range(2, 6)) == blocks
    assert model.layer_1.conv.groups == 64 and model.layer_1.conv.stride == (2, 2)
    se = [b.se for i in range(2, 6) for b in getattr(model, f"layer_{i}")]
    assert all(s is not None for s in se) == pair["variant"].startswith("se_")
    if pair["variant"] == "resnet50":
        # torchvision's ResNet-50 (25,557,032 at 1,000 classes) with CVNets'
        # stem: a 3×3 conv for the 7×7 one, and a depthwise 3×3 conv + BN for
        # the max pool
        n = sum(p.numel() for p in model.parameters()) - 2049 * 13 + 2049 * 1000
        assert n == 25_557_032 - 7 * 7 * 3 * 64 + 3 * 3 * 3 * 64 + 3 * 3 * 64 + 2 * 64
