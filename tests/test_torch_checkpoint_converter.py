"""The port's reference-checkpoint converter (cvnets_tpu_torch/utils/
torch_checkpoint_converter.py) against the JAX package's
(cvnets_tpu/utils/torch_checkpoint_converter.py), on a micro MobileViTv2 and a
ResNet-18 at 13 classes, float32 on the CPU.

A reference checkpoint is made from the port's model filled with perturbed JAX
weights: its state dict, every tensor renamed to a name of another scheme
(``module.blocks.<i>.<leaf>``) in the same order, as a published CVNets file
names its modules otherwise. The same file goes through JAX's
``convert_torch_checkpoint`` onto a fresh flax tree in definition order and
``load_jax_params``, and through the port's ``convert_checkpoint`` onto a fresh
port model: the two state dicts are equal to each other and to the source, bit
for bit, with nothing unmatched on either side (BN's step counters have no
JAX leaf and are left out). Then the scope surgery (``--model.rename-scopes-map``,
``--model.resume-exclude-scopes``) gives the same tensors on both sides, and
the converted port model's logits are JAX's on the JAX-converted tree, within
the float tests' 1e-4 of max(1, the largest logit)."""

from __future__ import annotations

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
    assert_logits_match,
    both_opts,
    nchw,
    perturbed_variables,
    port_model_from,
    reference_names,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

MODELS = {
    "mobilevit_v2": SMALL_MODEL_ARGS,
    "resnet18": ["--model.classification.name", "resnet", "--model.activation.name", "relu",
                 "--model.classification.resnet.depth", "18", *CONV_FAMILY_ARGS],
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module", params=list(MODELS))
def case(request, tmp_path_factory):
    from cvnets_tpu.models import get_model as jax_get_model

    opts_jax, opts_torch = both_opts(MODELS[request.param])
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = jax_get_model(opts_jax)
    source = port_model_from(opts_torch, perturbed_variables(jmodel, x)).state_dict()
    path = str(tmp_path_factory.mktemp(request.param) / "reference.pt")
    torch.save({"model_state_dict": reference_names(source)}, path)
    key = jax.random.PRNGKey(1)
    # eager init: JAX's walk needs the tree in definition order, which jit
    # and jax.tree_util (both sort dict keys) would lose
    fresh_tree = jmodel.init({"params": key, "dropout": key}, jnp.asarray(x[:1]),
                             training=False)
    return dict(opts_jax=opts_jax, opts_torch=opts_torch, jmodel=jmodel, x=x, source=source,
                path=path, fresh_tree=as_numpy(fresh_tree))


def as_numpy(tree):
    """numpy leaves, every dict in its own key order."""
    return ({k: as_numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.asarray(tree))


def jax_converted(case, rename_map=None, exclude_scopes=""):
    """JAX's converter and ``load_jax_params``: (port state dict, tree, report)."""
    from cvnets_tpu.utils.torch_checkpoint_converter import (
        convert_torch_checkpoint,
        load_torch_state_dict,
    )
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    tree = case["fresh_tree"]
    params, stats, unmatched = convert_torch_checkpoint(
        load_torch_state_dict(case["path"]), tree["params"], tree.get("batch_stats"),
        rename_map=rename_map, exclude_scopes=exclude_scopes)
    model = get_model(case["opts_torch"], device="cpu")
    load_jax_params(model, params, stats)
    return model.state_dict(), {"params": params, "batch_stats": stats}, unmatched


def port_converted(case, rename_map=(), exclude_scopes=""):
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.torch_checkpoint_converter import (
        convert_checkpoint,
        load_torch_state_dict,
    )

    fresh = get_model(case["opts_torch"], generator=torch.Generator().manual_seed(5),
                      device="cpu")
    return convert_checkpoint(load_torch_state_dict(case["path"]), fresh.state_dict(),
                              rename_map=rename_map, exclude_scopes=exclude_scopes)


def _params(state_dict: dict) -> dict:
    return {k: v for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}


def test_both_converters_give_the_source_state_dict(case):
    want, _, jax_unmatched = jax_converted(case)
    got, unmatched = port_converted(case)
    assert not jax_unmatched and not unmatched, (jax_unmatched[:5], unmatched[:5])
    for key, value in _params(case["source"]).items():
        assert torch.equal(want[key], value), key
        assert torch.equal(got[key], value), key
    assert set(_params(got)) == set(_params(want))


def test_the_scope_surgery_matches_jax(case):
    """The file's keys with a ``checkpoint.`` prefix that the rename map takes
    off, and the first module excluded (the stem's conv weight is dropped
    before the walk, so the port's keeps its value and the walk goes on from
    the stem's norm): both converters keep and take the same tensors, and
    report as many unmatched."""
    renamed = {f"checkpoint.{k}": v for k, v in torch.load(
        case["path"], weights_only=True)["model_state_dict"].items()}
    torch.save(renamed, case["path"] + ".prefixed")
    prefixed = dict(case, path=case["path"] + ".prefixed")
    rename = [(r"^checkpoint\.", "")]
    exclude = r"module\.blocks\.0\."
    want, _, jax_unmatched = jax_converted(prefixed, rename_map=rename, exclude_scopes=exclude)
    got, unmatched = port_converted(prefixed, rename_map=rename, exclude_scopes=exclude)
    assert len(unmatched) == len(jax_unmatched) > 0
    source = _params(case["source"])
    first = ["conv_1.conv.weight"]
    assert not torch.equal(got[first[0]], source[first[0]])
    for key in source:
        if key not in first:
            assert torch.equal(got[key], source[key]), key
            assert torch.equal(want[key], source[key]), key


def test_the_converted_model_gives_the_jax_logits(case):
    """The port model filled by the port's converter against the JAX model on
    the tree JAX's converter made from the same file (eval logits)."""
    from cvnets_tpu_torch.models import get_model

    _, tree, _ = jax_converted(case)
    x = case["x"]
    want = np.asarray(jax.jit(lambda v: case["jmodel"].apply(v, jnp.asarray(x),
                                                             training=False))(tree))
    got_sd, _ = port_converted(case)
    model = get_model(case["opts_torch"], device="cpu")
    model.load_state_dict(got_sd)
    with torch.no_grad():
        got = model.eval()(nchw(x)).numpy()
    assert_logits_match(got, want)
