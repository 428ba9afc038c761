"""RegNet in the PyTorch port against the JAX package: every mode's stage
widths, depths, group widths and SE ratio from the port's copy of the config
against JAX's (exact: the widths come from a float quantization copied
operation for operation), the full-width parameter shapes of the yaml's
y_16gf and of x_400mf, and RegNetY-200MF's logits, BN statistics, grads and
leaves at 64 px, batch 2, 13 classes, float32 on the CPU, with the
tolerances of ``torch_port_helpers`` (LOGIT_ATOL, 2e-4 of a BN leaf's max,
5e-4 of the largest grad)."""

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
    assert_stats_match,
    both_opts,
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


def _modes():
    from cvnets_tpu_torch.models.classification.config.regnet import _MODES

    return sorted(_MODES)


def _args(mode):
    return ["--model.classification.name", "regnet", "--model.classification.regnet.mode",
            mode, "--model.activation.name", "relu", *CONV_FAMILY_ARGS]


def test_the_mode_table_is_the_jax_one():
    from cvnets_tpu.models.classification.config import regnet as jax_cfg
    from cvnets_tpu_torch.models.classification.config import regnet as port_cfg

    assert port_cfg._MODES == jax_cfg._MODES
    assert len(port_cfg._MODES) == 24


@pytest.mark.parametrize("mode", _modes())
def test_stage_widths_depths_and_groups_are_the_jax_ones(mode):
    from cvnets_tpu.models.classification.config.regnet import (
        get_configuration as jax_configuration,
    )
    from cvnets_tpu_torch.models.classification.config.regnet import get_configuration

    opts_jax, opts_torch = both_opts(_args(mode))
    got, want = get_configuration(opts_torch), jax_configuration(opts_jax)
    assert got == want
    assert sorted(got) == ["layer1", "layer2", "layer3", "layer4"]
    assert all(c["width"] % c["groups"] == 0 for c in got.values())


@pytest.mark.parametrize("mode", ["y_16gf", "x_400mf"])
def test_full_width_parameter_shapes_are_the_jax_ones(mode):
    """Every tensor of the port at 1,000 classes has the JAX leaf's shape
    (``jax.eval_shape``, no weights drawn), grouped 3×3 kernels included."""
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model

    opts_jax, opts_torch = both_opts(["--model.classification.name", "regnet",
                                      "--model.classification.regnet.mode", mode,
                                      "--dataset.category", "classification"])
    model = get_model(opts_torch, device="cpu")
    assert port_shapes(model) == jax_leaf_shapes(jax_model(opts_jax))
    groups = {b.conv2.conv.groups for i in range(2, 6) for b in getattr(model, f"layer_{i}")}
    assert groups - {1} and all(g > 1 for g in groups)  # grouped, not depthwise


@pytest.fixture(scope="module")
def pair():
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(_args("y_200mf"))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = np.array([3, 11])
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    return dict(opts_torch=opts_torch, variables=variables,
                jax=jax_outputs(jmodel, variables, x, y, opts_jax),
                port=port_outputs(opts_torch, variables, x, y))


def test_regnety_200mf_eval_and_train_logits_and_bn_stats_match(pair):
    assert_logits_match(pair["port"]["eval"], pair["jax"]["eval"])
    assert_logits_match(pair["port"]["train"], pair["jax"]["train"])
    assert_stats_match(pair["port"]["state"], pair["jax"]["stats"])


def test_regnety_200mf_loss_and_grads_match(pair):
    assert_loss_matches(pair["port"]["loss"], pair["jax"]["loss"], pair["jax"]["train"])
    assert_grads_match(pair["port"]["grads"], pair["jax"]["grads"])
    assert_grads_match(pair["port"]["eval_grads"], pair["jax"]["eval_grads"])


def test_regnety_200mf_every_leaf_is_loaded(pair):
    model = port_model_from(pair["opts_torch"], pair["variables"])
    assert_every_leaf_loaded(model, pair["variables"])
    assert all(b.se is not None for i in range(2, 6) for b in getattr(model, f"layer_{i}"))
