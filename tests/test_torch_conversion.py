"""``cvnets_tpu_torch.main_conversion`` on the CPU (counterpart of
tests/test_conversion.py): the exported program of a micro MobileViTv2 (its
weights from a reference-layout checkpoint, through the converter) and of the
micro ViT (from a port checkpoint) records the attention kernels' forward as
``cvnets_tpu_torch`` custom op nodes (9 separable, 2 MHA), and after
``torch.export.save`` and ``load`` gives the live port model's logits bit for
bit and JAX's jitted forward on the same weights within the float tests' 1e-4
of max(1, the largest logit); ``--conversion.reparameterize`` exports the
folded micro MobileOne, which gives JAX's folded model's logits
(``get_exportable_params`` on the same weights) within the JAX test's 5e-4
absolute and 5e-3 relative, and no branch of a MobileOne block is left."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    CONV_FAMILY_ARGS,
    SMALL_MODEL_ARGS,
    VIT_MICRO_ARGS,
    assert_logits_match,
    both_opts,
    nchw,
    perturbed_variables,
    port_model_from,
    reference_names,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

SIZE = 64
CROP = ["--sampler.bs.crop-size-width", str(SIZE), "--sampler.bs.crop-size-height", str(SIZE)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.mark.parametrize("name, args, n_ops, op", [
    ("mobilevit_v2", SMALL_MODEL_ARGS, 9, "separable_attention_fwd"),
    ("vit", VIT_MICRO_ARGS, 2, "mha_attention_fwd"),
])
def test_export_round_trip_matches_the_live_model_and_jax(name, args, n_ops, op, tmp_path):
    from cvnets_tpu.models import get_model as jax_get_model
    from cvnets_tpu_torch.main_conversion import EvalForward, main_worker_conversion

    opts_jax, opts_torch = both_opts(args)
    x = np.random.default_rng(0).standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    jmodel = jax_get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    model = port_model_from(opts_torch, variables).eval()
    weights = str(tmp_path / "weights.pt")
    if name == "mobilevit_v2":
        torch.save({"model_state_dict": reference_names(model.state_dict())}, weights)
    else:
        torch.save(model.state_dict(), weights)
    done = main_worker_conversion(args=args + CROP + [
        "--model.classification.pretrained", weights,
        "--common.results-loc", str(tmp_path), "--common.run-label", name], device="cpu")
    assert done.path == os.path.join(str(tmp_path), name, "model.pt2")
    assert os.path.isfile(os.path.join(str(tmp_path), name, "model_graph.txt"))
    assert done.custom_ops == [f"cvnets_tpu_torch.{op}.default"] * n_ops
    assert done.rel_diff == 0.0
    program = torch.export.load(done.path)
    with torch.no_grad():
        got = program.module()(nchw(x)).numpy()
        live = EvalForward(model)(nchw(x)).numpy()
    np.testing.assert_array_equal(got, live)
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), training=False))(
        variables))
    assert_logits_match(got, want)


MOBILEONE_ARGS = ["--model.classification.name", "mobileone",
                  "--model.classification.mobileone.variant", "micro",
                  "--model.activation.name", "relu", *CONV_FAMILY_ARGS]


def test_export_reparameterize_folds_mobileone(tmp_path, monkeypatch):
    from cvnets_tpu.models import get_model as jax_get_model
    from cvnets_tpu.models.classification import mobileone as jax_mobileone
    from cvnets_tpu.utils.reparam_utils import get_exportable_params
    from cvnets_tpu_torch.main_conversion import main_worker_conversion
    from cvnets_tpu_torch.models.classification import mobileone as port_mobileone

    from test_torch_mobileone import MICRO, _tamed

    for module in (jax_mobileone, port_mobileone):
        monkeypatch.setitem(module._VARIANTS, "micro", MICRO)
    opts_jax, opts_torch = both_opts(MOBILEONE_ARGS)
    x = np.random.default_rng(0).standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    jmodel = jax_get_model(opts_jax)
    variables = _tamed(perturbed_variables(jmodel, x))
    weights = str(tmp_path / "weights.pt")
    torch.save(port_model_from(opts_torch, variables).state_dict(), weights)

    inf_opts, _ = both_opts(MOBILEONE_ARGS + ["--model.classification.mobileone.inference-mode"])
    folded = get_exportable_params(variables["params"], variables.get("batch_stats", {}))
    want = np.asarray(jax_get_model(inf_opts).apply({"params": folded}, jnp.asarray(x),
                                                    training=False))

    done = main_worker_conversion(args=MOBILEONE_ARGS + CROP + [
        "--model.classification.pretrained", weights, "--conversion.reparameterize",
        "--common.results-loc", str(tmp_path)], device="cpu")
    program = torch.export.load(done.path)
    with torch.no_grad():
        got = program.module()(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3)
    graph = program.graph_module.code
    assert "conv_branch" not in graph and "skip_bn" not in graph and "reparam_conv" in graph
