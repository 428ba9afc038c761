"""DeepLabv3 on a ViT encoder in the PyTorch port against the JAX package on
the same weights: the micro ViT (E = 64, 2 blocks, 4 heads of 16) with the
output-stride stem (strides 4, 2, 2 at 16; 2, 2, 2 at 8), a 32-channel ASPP
at deeplabv3_vit_base_clip_os_16.yaml's rates, 13 classes, dropouts 0, 64 px,
batch 2, float32 on the CPU. At 64 px the ViT has 4² + 1 tokens at output
stride 16 and 8² + 1 at 8, so its positional table is resampled from 196
entries. Checked: the train-mode head-resolution logits that the seg CE
consumes, the eval logits upsampled to 64², the BN statistics after one
train forward (the stem's and the head's; with the yaml's ``layer_norm`` the
model has none), the seg CE and every parameter's gradient through it.
JAX's ViT computes its logits inside ``extract_end_points_all``, so its tree
has an ``encoder/classifier`` that the port's has not: the weight carrier
gets the tree without it.

Tolerances, measured in a script on these cases: the head's train logits
differ by at most 3.1e-5 of their largest value (bound 2e-4,
test_torch_deeplabv3.py's), the eval logits by 1.9e-6 (bound 1e-4
absolute), the BN statistics by 5.7e-5 of each leaf's largest (bound 2e-4),
the gradients by 5.4e-4 of the largest grad, at the ASPP's pooling branch,
whose BN normalizes over one pixel an image (bound 2e-3); the loss is held
by the logits' bound (``assert_loss_matches``). The ViT-B/16 yamls build
through the port and train on the composite loss, whose
``neural_augmentation`` term is 0 (ROADMAP §3 pinned: a segmentation
encoder builds no augmentor)."""

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
    VIT_MICRO_ARGS,
    assert_loss_matches,
    both_opts,
    flat_leaves,
    nchw,
    perturbed_variables,
    seg_targets,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_OUT_REL = 2e-4  # train-mode outputs, of the largest
LOGIT_ATOL = 1e-4
GRAD_REL = 2e-3  # of the largest grad
YAML = "examples/vit/segmentation/ade20k/deeplabv3_vit_base_clip_os_{}.yaml"

# the ViT yamls' head, cut to 13 classes, a 32-channel ASPP and no dropout
VIT_SEG_MICRO_ARGS = [a for a in VIT_MICRO_ARGS if a not in ("--dataset.category",
                                                            "classification")] + [
    "--dataset.category", "segmentation",
    "--model.segmentation.name", "encoder_decoder",
    "--model.segmentation.n-classes", "13",
    "--model.segmentation.seg-head", "deeplabv3",
    "--model.segmentation.deeplabv3.aspp-out-channels", "32",
    "--model.segmentation.deeplabv3.aspp-rates", "12", "24", "36",
    "--model.segmentation.deeplabv3.aspp-dropout", "0",
    "--model.segmentation.classifier-dropout", "0",
    "--loss.category", "segmentation",
    "--loss.segmentation.name", "cross_entropy",
    "--loss.segmentation.cross-entropy.ignore-index", "255",
]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def without_classifier(variables: dict) -> dict:
    """The JAX tree without ``encoder/classifier``, which the port's
    segmentation encoder does not build."""
    params = dict(variables["params"])
    params["encoder"] = {k: v for k, v in params["encoder"].items() if k != "classifier"}
    return {**variables, "params": params}


CASES = {"os16": (16, "batch_norm"), "os8": (8, "batch_norm"),
         "os16_layer_norm": (16, "layer_norm")}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    from cvnets_tpu.models import get_model

    output_stride, norm = CASES[request.param]
    opts_jax, opts_torch = both_opts(VIT_SEG_MICRO_ARGS + [
        "--model.segmentation.output-stride", str(output_stride),
        "--model.normalization.name", norm])
    rng = np.random.default_rng(output_stride)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = seg_targets(rng, 2, 64)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    return dict(x=x, y=y, jmodel=jmodel, variables=variables, opts_jax=opts_jax,
                opts_torch=opts_torch, os=output_stride, norm=norm)


def port_model(pair):
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    model = get_model(pair["opts_torch"], device="cpu")
    stripped = without_classifier(pair["variables"])
    load_jax_params(model, stripped["params"], stripped.get("batch_stats"))
    return model


def test_stem_and_token_grid_follow_the_output_stride(pair):
    model = port_model(pair)
    stem = [getattr(model.encoder, f"patch_emb_{i}").conv for i in range(3)]
    first = 2 if pair["os"] == 8 else 4
    assert [(c.kernel_size[0], c.stride[0]) for c in stem] == [(first, first), (2, 2), (2, 2)]
    with torch.no_grad():
        taps = model.eval().encoder.extract_end_points_all(nchw(pair["x"]))
    assert list(taps) == ["out_l5"]
    assert tuple(taps["out_l5"].shape) == (2, 64, 64 // pair["os"], 64 // pair["os"])
    jax_tree = pair["variables"]["params"]["encoder"]
    assert "classifier" in jax_tree and model.encoder.classifier is None


def test_train_logits_bn_stats_loss_and_grads_match(pair):
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu_torch.loss import build_loss_fn as torch_loss
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    x, y = jnp.asarray(pair["x"]), jnp.asarray(pair["y"])
    jcrit = jax_loss(pair["opts_jax"])
    variables = pair["variables"]

    def loss_fn(params):
        pred, new = pair["jmodel"].apply({**variables, "params": params}, x, training=True,
                                         mutable=["batch_stats"],
                                         rngs={"dropout": jax.random.PRNGKey(0)})
        return jcrit(x, pred, y, training=True), (pred, new)

    (jloss, (jpred, jnew)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    model = port_model(pair).train()
    pred = model(nchw(pair["x"]))
    head = 64 // pair["os"]
    assert tuple(pred.shape) == (2, 13, head, head)
    want = np.asarray(jpred)
    np.testing.assert_allclose(pred.detach().permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=TRAIN_OUT_REL * np.abs(want).max())
    loss = torch_loss(pair["opts_torch"])(None, pred, torch.from_numpy(pair["y"]),
                                          training=True)
    assert_loss_matches(loss.item(), float(jloss), want)
    loss.backward()

    stats = list(flat_leaves(jax.tree_util.tree_map(np.asarray, jnew.get("batch_stats", {}))))
    assert bool(stats) == (pair["norm"] == "batch_norm")
    state = model.state_dict()
    for path, leaf in stats:
        key = torch_key(path)
        np.testing.assert_allclose(state[key].numpy(), leaf, rtol=0,
                                   atol=2e-4 * float(np.abs(leaf).max()), err_msg=key)

    grads = without_classifier({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    named = dict(model.named_parameters())
    leaves = list(flat_leaves(grads["params"]))
    assert len(leaves) == len(named)
    gmax = max(float(np.abs(g).max()) for _, g in leaves)
    for path, g in leaves:
        key = torch_key(path)
        np.testing.assert_allclose(named[key].grad.numpy(), to_torch_layout(path, g), rtol=0,
                                   atol=GRAD_REL * gmax, err_msg=key)


def test_eval_logits_are_upsampled_and_match(pair):
    ref = pair["jmodel"].apply(pair["variables"], jnp.asarray(pair["x"]), training=False)
    model = port_model(pair).eval()
    with torch.no_grad():
        out = model(nchw(pair["x"]))
    assert tuple(out.shape) == (2, 13, 64, 64)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("output_stride", [16, 8])
def test_the_vit_b_yamls_train_on_the_composite_loss_with_a_zero_augmentation_term(
        output_stride):
    """The yaml (its ``finetune`` cleared: the released CLIP weights are not in
    the repo), cut to the micro ViT and 3 classes: one train forward, the
    composite loss, whose neural-augmentation term is 0 and whose total is
    the seg CE."""
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=[
        "--common.config-file", os.path.join(REPO, YAML.format(output_stride)),
        "--common.override-kwargs", "common.finetune=", "model.classification.vit.mode=micro",
        "model.segmentation.n_classes=3", "model.segmentation.deeplabv3.aspp_out_channels=16",
        "common.mixed_precision=false"])
    assert getattr(opts, "model.segmentation.output_stride") == output_stride
    assert not getattr(opts, "model.segmentation.use_aux_head")
    model = get_model(opts, device="cpu").train()
    assert getattr(model, "neural_augmentor", None) is None
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    pred = model(x)
    assert tuple(pred.shape) == (2, 3, 64 // output_stride, 64 // output_stride)
    y = torch.from_numpy(seg_targets(np.random.default_rng(0), 2, 64, 3))
    losses = build_loss_fn(opts, device="cpu")(x, pred, y, training=True, epoch=0,
                                               iterations=0)
    assert float(losses["neural_augmentation"]) == 0.0
    assert losses["total_loss"].item() == pytest.approx(losses["segmentation"].item())


@pytest.mark.parametrize("output_stride", [16, 8])
def test_chip_smoke_flags_are_the_yamls(output_stride):
    """chip_smoke.py's ``VIT_SEG_ARGS`` / ``VIT_SEG_8_ARGS`` with its composite
    list parse to the yaml's values but for its data roots and the
    ``finetune`` checkpoint, which is not in the repo."""
    sys.path.insert(0, REPO)
    from chip_smoke import VIT_SEG_8_ARGS, VIT_SEG_ARGS, path_opts
    from torch_port_helpers import flags_differ_from_yaml

    args = VIT_SEG_ARGS if output_stride == 16 else VIT_SEG_8_ARGS
    assert flags_differ_from_yaml(path_opts(args), os.path.join(REPO, YAML.format(
        output_stride))) == ["common.config_file", "common.finetune", "dataset.root_train",
                             "dataset.root_val", "taskname"]
