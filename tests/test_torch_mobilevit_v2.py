"""MobileViTv2 in the PyTorch port against the JAX package on the same weights:
width 0.5, 64 px, batch 2, float32 on the CPU. Logits in eval and train mode, BN
running statistics after one train forward, and every parameter gradient of the
label-smoothed CE loss."""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    SMALL_MODEL_ARGS,
    both_opts,
    nchw,
    perturbed_variables,
    port_model_from,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

# f32 on both sides; the sums run in another order (XLA vs ATen), so logits agree
# to ~1e-5. test_reference_parity.py uses the same 1e-4.
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(SMALL_MODEL_ARGS + [
        "--loss.classification.cross-entropy.label-smoothing", "0.1"])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = np.array([3, 11])
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    tmodel = port_model_from(opts_torch, variables)
    return dict(x=x, y=y, jmodel=jmodel, variables=variables, tmodel=tmodel,
                opts_jax=opts_jax, opts_torch=opts_torch)


def test_eval_logits_match(pair):
    ref = pair["jmodel"].apply(pair["variables"], jnp.asarray(pair["x"]), training=False)
    model = pair["tmodel"].eval()
    with torch.no_grad():
        out = model(nchw(pair["x"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)


def test_train_logits_and_bn_stats_match(pair):
    from cvnets_tpu_torch.utils.jax_params import torch_key

    ref, new_vars = pair["jmodel"].apply(
        pair["variables"], jnp.asarray(pair["x"]), training=True,
        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    model = port_model_from(pair["opts_torch"], pair["variables"]).train()
    with torch.no_grad():
        out = model(nchw(pair["x"]))
    # batch-statistic BN amplifies the f32 noise floor layer by layer (see
    # test_trajectory_parity.py's docstring); measured 1.3e-5 here
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)
    state = model.state_dict()
    stats = jax.tree_util.tree_flatten_with_path(new_vars["batch_stats"])[0]
    assert len(stats) > 0
    for path, leaf in stats:
        key = torch_key(tuple(p.key for p in path))
        leaf = np.asarray(leaf)
        # the deepest BNs see 8 elements per channel (2 images × 2×2), where the
        # amplified noise reaches ~4e-5 of the tensor's largest entry; means near
        # zero rule out a relative bound per element
        np.testing.assert_allclose(state[key].numpy(), leaf, rtol=0,
                                   atol=2e-4 * float(np.abs(leaf).max()), err_msg=key)


def test_param_grads_match(pair):
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu_torch.loss import build_loss_fn as torch_loss
    from cvnets_tpu_torch.utils.jax_params import torch_key

    variables, x, y = pair["variables"], jnp.asarray(pair["x"]), jnp.asarray(pair["y"])
    jcrit = jax_loss(pair["opts_jax"])

    def loss_fn(params):
        pred, _ = pair["jmodel"].apply(
            {**variables, "params": params}, x, training=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return jcrit(x, pred, y, training=True)

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])

    model = port_model_from(pair["opts_torch"], variables).train()
    loss = torch_loss(pair["opts_torch"])(None, model(nchw(pair["x"])),
                                          torch.from_numpy(pair["y"]), training=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)

    named = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(named)
    # grads flow back through every batch-statistic BN of the train forward, which
    # amplifies the f32 noise in proportion to the largest upstream grads, not to
    # each tensor's own (a bias whose shift the next BN cancels has a true grad of
    # ~0 and noise of ~1e-6). Measured: 1.2e-4 of the largest grad; bound 5e-4.
    gmax = max(float(np.abs(np.asarray(g)).max()) for _, g in flat)
    for path, g in flat:
        key = torch_key(tuple(p.key for p in path))
        g = np.asarray(g)
        g = g.transpose(3, 2, 0, 1) if g.ndim == 4 else (g.T if g.ndim == 2 else g)
        np.testing.assert_allclose(named[key].grad.numpy(), g, rtol=0,
                                   atol=5e-4 * gmax, err_msg=key)


def test_load_jax_params_rejects_incomplete_or_extra_trees(pair):
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    params = pair["variables"]["params"]
    model = port_model_from(pair["opts_torch"], pair["variables"])
    missing = {k: v for k, v in params.items() if k != "classifier"}
    with pytest.raises(KeyError, match="no flax leaf"):
        load_jax_params(model, missing, pair["variables"]["batch_stats"])
    extra = {**params, "conv_9": {"conv": {"kernel": np.zeros((3, 3, 3, 8))}}}
    with pytest.raises(KeyError, match="no such parameter"):
        load_jax_params(model, extra, pair["variables"]["batch_stats"])


def test_init_draws_from_the_flax_distributions(pair):
    """kaiming_normal convs (and the attention projections) and trunc_normal
    linears: each weight tensor's std and range match the flax init's. The
    estimate of a std from n >= 1000 draws is within ~2.2% (1/sqrt(2n)) of the
    truth; the bound is 15%. Draws come from the seeded generator alone."""
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.jax_params import torch_key

    model = get_model(pair["opts_torch"], device="cpu")
    assert torch.equal(model.conv_1.conv.weight,
                       get_model(pair["opts_torch"], device="cpu").conv_1.conv.weight)
    weights = model.state_dict()
    checked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(pair["variables"]["params"])[0]:
        leaf = np.asarray(leaf)
        if path[-1].key != "kernel" or leaf.size < 1000:
            continue
        got = weights[torch_key(tuple(p.key for p in path))].numpy()
        assert got.std() == pytest.approx(leaf.std(), rel=0.15), path
        assert np.abs(got).max() <= np.abs(leaf).max() * 1.15, path
        checked += 1
    assert checked >= 30


@pytest.mark.parametrize("h,w", [(8, 6), (5, 7), (1, 3)])
def test_unfold_resize_fold_match_jax(h, w):
    """The NCHW patch reshapes give the JAX NHWC patches, and an odd size is
    resized with align_corners=True as the JAX package does (F.interpolate's
    default, half-pixel centres, would differ). Same f32 weights, two-term sums."""
    from cvnets_tpu.modules import mobilevit_block as jax_block
    from cvnets_tpu_torch.modules import mobilevit_block as port_block

    x = np.random.default_rng(2).standard_normal((2, h, w, 3)).astype(np.float32)
    ref = np.asarray(jax_block.resize_to_patch_multiple(jnp.asarray(x), 2, 2))
    out = port_block.resize_to_patch_multiple(nchw(x), 2, 2)
    out_nhwc = out.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out_nhwc, ref, atol=1e-6, rtol=0)

    # pure reshapes: bit-equal on the same input
    ref_patches, out_hw = jax_block.unfold_nhwc(jnp.asarray(out_nhwc), 2, 2)
    patches = port_block.unfold_nchw(out, 2, 2)
    np.testing.assert_array_equal(patches.numpy(), np.asarray(ref_patches))
    np.testing.assert_array_equal(port_block.fold_nchw(patches, out_hw, 2, 2).numpy(),
                                  out.numpy())


def test_conv_layer_with_layer_norm_2d_matches_jax():
    """A conv followed by layer_norm_2d (GroupNorm over C, H, W) keeps its bias
    (the reference quirk both packages mirror) and normalises jointly."""
    from cvnets_tpu.layers.conv_layer import ConvLayer2d as JaxConv
    from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d

    opts_jax, opts_torch = both_opts(["--model.normalization.name", "layer_norm_2d",
                                      "--model.activation.name", "swish"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    jconv = JaxConv(opts=opts_jax, out_channels=6, kernel_size=3, stride=2)
    variables = perturbed_variables(jconv, x, seed=1)
    params = variables["params"]
    assert "bias" in params["conv"]
    ref = jconv.apply(variables, jnp.asarray(x), training=True)

    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    conv = ConvLayer2d(opts_torch, 4, 6, kernel_size=3, stride=2)
    load_jax_params(conv, params)
    with torch.no_grad():
        out = conv(nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
