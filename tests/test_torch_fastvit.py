"""FastViT in the PyTorch port against the JAX package, float32 on the CPU,
13 classes, 64 px, batch 2, the same perturbed weights on both sides (through
``utils/jax_params.py``; the layer scales are moved off their 1e-5 init to
about 0.1, so that every branch they scale shows), with the tolerances of
``torch_port_helpers``:

* T8 (RepMixer blocks throughout, gelu as fastvit.yaml) and SA12 (its last
  stage a RepCPE and six ``AttentionBlock``s, heads of D = 32): eval and train
  logits, BN statistics (the MobileOne skips and the attention block's norm
  are stock flax BatchNorms: biased running variance), the loss, train- and
  eval-mode grads, every leaf;
* ``--model.classification.fastvit.inference-mode`` builds the JAX package's
  folded structures (RepMixer's ``reparam_conv`` without a layer scale, RepCPE
  without its identity, folded MobileOne and RepLK blocks): the shapes of
  every T8 and SA12 tensor against ``jax.eval_shape``'s, and SA12's folded
  forward against JAX's on the same weights;
* fastvit.yaml's flags build FastViT-T8 (4.0 M parameters in the training form).
"""

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
    nchw,
    perturbed_variables,
    port_model_from,
    port_outputs,
    port_shapes,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


def fastvit_args(variant: str, *extra):
    return ["--model.classification.name", "fastvit",
            "--model.classification.fastvit.variant", variant,
            "--model.activation.name", "gelu", *CONV_FAMILY_ARGS, *extra]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def with_layer_scales(variables: dict, rng: np.random.Generator) -> dict:
    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    (0.1 + 0.02 * rng.standard_normal(np.shape(v))).astype(np.float32)
                    if k.startswith("layer_scale") else v)
                for k, v in tree.items()}

    return {**variables, "params": walk(variables["params"])}


def _pair(variant: str):
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(fastvit_args(variant))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = np.array([3, 11])
    jmodel = get_model(opts_jax)
    variables = with_layer_scales(perturbed_variables(jmodel, x), rng)
    return dict(x=x, opts_torch=opts_torch, variables=variables,
                jax=jax_outputs(jmodel, variables, x, y, opts_jax),
                port=port_outputs(opts_torch, variables, x, y))


@pytest.fixture(scope="module", params=["T8", "SA12"])
def pair(request):
    return _pair(request.param)


def test_logits_and_bn_stats_match(pair):
    assert_logits_match(pair["port"]["eval"], pair["jax"]["eval"])
    assert_logits_match(pair["port"]["train"], pair["jax"]["train"])
    assert_stats_match(pair["port"]["state"], pair["jax"]["stats"])


def test_loss_and_grads_match(pair):
    assert_loss_matches(pair["port"]["loss"], pair["jax"]["loss"], pair["jax"]["train"])
    assert_grads_match(pair["port"]["grads"], pair["jax"]["grads"])
    assert_grads_match(pair["port"]["eval_grads"], pair["jax"]["eval_grads"])


def test_every_leaf_is_loaded(pair):
    assert_every_leaf_loaded(port_model_from(pair["opts_torch"], pair["variables"]),
                             pair["variables"])


@pytest.mark.parametrize("variant", ["T8", "SA12"])
@pytest.mark.parametrize("inference", [False, True])
def test_shapes_are_the_jax_trees(variant, inference):
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model

    extra = ["--model.classification.fastvit.inference-mode"] if inference else []
    opts_jax, opts_torch = both_opts(fastvit_args(variant, *extra))
    model = get_model(opts_torch, device="cpu")
    assert port_shapes(model) == jax_leaf_shapes(jax_model(opts_jax))
    mixer = model.layer_2[0].token_mixer
    assert (mixer.reparam_conv is not None) == inference
    assert (mixer.layer_scale is None) == inference


def test_inference_mode_forward_matches_jax():
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(fastvit_args(
        "SA12", "--model.classification.fastvit.inference-mode"))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = get_model(opts_jax)
    variables = with_layer_scales(perturbed_variables(jmodel, x, seed=1), rng)
    want = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), training=False))(variables)
    model = port_model_from(opts_torch, variables).eval()
    assert model.layer_5[1].inference_mode  # the RepCPE without its identity
    with torch.no_grad():
        assert_logits_match(model(nchw(x)).numpy(), np.asarray(want))


def test_fastvit_yaml_builds_fastvit_t8():
    from cvnets_tpu_torch.models import get_model

    _, opts_torch = both_opts(["--common.config-file",
                               "config/classification/imagenet/fastvit.yaml"])
    model = get_model(opts_torch, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 4_026_232  # the training form
    assert [len(getattr(model, f"layer_{i}")) for i in range(2, 6)] == [2, 3, 5, 3]
