"""MobileOne and its branch folding in the PyTorch port against the JAX package:
a micro MobileOne (s0's widths and four conv branches a block, one or two
block pairs a stage, SE in the last pair of stages 3 and 4: a "micro" entry
that the ``micro`` fixture puts into both packages' variant tables, no file
edited) at 64 px, batch 2, 13 classes, float32 on the CPU; s0-s4 at full
depth by their tensors' shapes.

* The training form: eval and train-mode logits, BN statistics (the skip
  branch's BN tracks the biased batch variance, as flax's stock BatchNorm
  does), grads in train and eval mode, and every leaf, with the tolerances of
  ``torch_port_helpers``.
* ``reparameterize_model`` folds the port's model into the weights of JAX's
  ``get_exportable_params`` (float64 folds on both sides, cast to float32:
  1e-6 of each tensor's largest value), and the folded eval forward equals the
  multi-branch one and JAX's folded model (LOGIT_ATOL).
* ``--model.classification.mobileone.inference-mode`` builds the folded model,
  which loads JAX's exported tree leaf for leaf.
* The RepLK block (FastViT's) and its fold, alone.

Each block's BN scales are divided by the square root of its branch count, so
that a sum of up to six unit-variance branches stays near 1 block after block
(s0's perturbed init reaches logits of 1e14 otherwise)."""

from __future__ import annotations

import copy
import sys

import jax
import jax.numpy as jnp
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
    flat_leaves,
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


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """torch on two threads: the suite's xdist workers share the cores."""
    with torch_threads(2):
        yield

ARGS = ["--model.classification.name", "mobileone",
        "--model.classification.mobileone.variant", "micro",
        "--model.activation.name", "relu", *CONV_FAMILY_ARGS]
MICRO = ([1, 1, 2, 1], (0.75, 1.0, 1.0, 2.0), 4, True)
N_BLOCKS = 1 + 2 * 5  # the stem and each pair's depthwise and pointwise blocks


@pytest.fixture(scope="module", autouse=True)
def micro():
    from cvnets_tpu.models.classification import mobileone as jax_mobileone
    from cvnets_tpu_torch.models.classification import mobileone as port_mobileone

    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_mobileone, port_mobileone):
            mp.setitem(module._VARIANTS, "micro", MICRO)
        yield


def _tamed(variables: dict) -> dict:
    """Each MobileOne block's BN scales over sqrt(its number of branches)."""
    variables = copy.deepcopy(variables)

    def walk(tree):
        if "conv_branch_0" in tree:
            branches = [k for k in tree if k.startswith("conv_branch_") or k == "scale_branch"]
            n = len(branches) + ("skip_bn" in tree)
            f = np.float32(1.0 / np.sqrt(n))
            for k in branches:
                tree[k]["norm"]["scale"] = tree[k]["norm"]["scale"] * f
            if "skip_bn" in tree:
                tree["skip_bn"]["scale"] = tree["skip_bn"]["scale"] * f
            return
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)

    walk(variables["params"])
    return variables


@pytest.fixture(scope="module")
def pair():
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(ARGS)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = np.array([3, 11])
    jmodel = get_model(opts_jax)
    variables = _tamed(perturbed_variables(jmodel, x))
    return dict(x=x, opts_jax=opts_jax, opts_torch=opts_torch, variables=variables,
                jax=jax_outputs(jmodel, variables, x, y, opts_jax),
                port=port_outputs(opts_torch, variables, x, y))


def test_multi_branch_logits_and_bn_stats_match(pair):
    assert np.abs(pair["jax"]["eval"]).max() < 100  # tamed
    assert_logits_match(pair["port"]["eval"], pair["jax"]["eval"])
    assert_logits_match(pair["port"]["train"], pair["jax"]["train"])
    assert_stats_match(pair["port"]["state"], pair["jax"]["stats"])


def test_multi_branch_loss_and_grads_match(pair):
    assert_loss_matches(pair["port"]["loss"], pair["jax"]["loss"], pair["jax"]["train"])
    assert_grads_match(pair["port"]["grads"], pair["jax"]["grads"])
    assert_grads_match(pair["port"]["eval_grads"], pair["jax"]["eval_grads"])


def test_every_leaf_is_loaded(pair):
    model = port_model_from(pair["opts_torch"], pair["variables"])
    assert_every_leaf_loaded(model, pair["variables"])
    block = model.layer_4[2]  # a depthwise block with every branch and SE
    assert block.skip_bn is not None and block.scale_branch is not None
    assert block.se is not None
    assert block.num_conv_branches == 4 and block.conv_branch_3.conv.groups == 256


@pytest.fixture(scope="module")
def folded(pair):
    from cvnets_tpu.utils.reparam_utils import get_exportable_params
    from cvnets_tpu_torch.utils.reparam_utils import reparameterize_model

    model = port_model_from(pair["opts_torch"], pair["variables"]).eval()
    x = nchw(pair["x"])
    with torch.no_grad():
        multi = model(x)
        reparameterize_model(model)
        fused = model(x)
    exported = get_exportable_params(
        jax.tree_util.tree_map(np.asarray, pair["variables"]["params"]),
        jax.tree_util.tree_map(np.asarray, pair["variables"]["batch_stats"]))
    return dict(model=model, multi=multi.numpy(), fused=fused.numpy(), exported=exported)


def test_folded_weights_are_jax_exportable_params(pair, folded):
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    state = folded["model"].state_dict()
    assert not any("branch" in k or "skip_bn" in k for k in state)
    leaves = list(flat_leaves(folded["exported"]))
    assert sum("reparam_conv" in "/".join(p) for p, _ in leaves) == 2 * N_BLOCKS
    for path, leaf in leaves:
        key = torch_key(path)
        want = to_torch_layout(path, leaf)
        np.testing.assert_allclose(state[key].numpy(), want, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(want).max())),
                                   err_msg=key)
    assert sorted(k for k in state if not k.endswith("num_batches_tracked")) == \
        sorted(torch_key(p) for p, _ in leaves)


def test_folded_forward_equals_the_multi_branch_one_and_jaxs(pair, folded):
    from cvnets_tpu.models import get_model

    assert_logits_match(folded["fused"], folded["multi"])
    opts_jax, _ = both_opts(ARGS + ["--model.classification.mobileone.inference-mode"])
    ref = get_model(opts_jax).apply({"params": folded["exported"]}, jnp.asarray(pair["x"]),
                                    training=False)
    assert_logits_match(folded["fused"], np.asarray(ref))


def test_inference_mode_builds_the_folded_model_and_loads_jax_exported_params(pair, folded):
    from cvnets_tpu_torch.modules.mobileone_block import MobileOneBlock
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    _, opts_torch = both_opts(ARGS + ["--model.classification.mobileone.inference-mode"])
    from cvnets_tpu_torch.models import get_model

    model = get_model(opts_torch, device="cpu").eval()
    blocks = [m for m in model.modules() if isinstance(m, MobileOneBlock)]
    assert len(blocks) == N_BLOCKS and all(b.reparam_conv is not None for b in blocks)
    load_jax_params(model, folded["exported"])
    with torch.no_grad():
        out = model(nchw(pair["x"])).numpy()
    assert_logits_match(out, folded["fused"])


@pytest.mark.parametrize("variant,branches,se_blocks", [
    ("s0", 4, 0), ("s1", 1, 0), ("s2", 1, 0), ("s3", 1, 0), ("s4", 1, 5 + 1)])
def test_variants_take_the_jax_table(variant, branches, se_blocks):
    """Branch count and SE placement (s4: the last 5 block pairs of stage 3 and
    stage 4's one), and every tensor's shape against JAX's (``jax.eval_shape``)."""
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.modules.mobileone_block import MobileOneBlock

    opts_jax, opts_torch = both_opts(["--model.classification.name", "mobileone",
                                      "--model.classification.mobileone.variant", variant,
                                      "--dataset.category", "classification"])
    model = get_model(opts_torch, device="cpu")
    blocks = [m for m in model.modules() if isinstance(m, MobileOneBlock)]
    assert {b.num_conv_branches for b in blocks[1:]} == {branches}
    assert sum(b.se is not None for b in blocks) == 2 * se_blocks
    assert port_shapes(model) == jax_leaf_shapes(jax_model(opts_jax))


def test_skip_branch_bn_tracks_the_biased_variance():
    from cvnets_tpu_torch.modules.mobileone_block import BiasedVarBatchNorm2d

    bn = BiasedVarBatchNorm2d(3, momentum=0.1).train()
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.BatchNorm2d(3, momentum=0.1).train()
    torch.testing.assert_close(bn(x), ref(x))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))
    assert ref.running_var.sub(bn.running_var).abs().min() > 5e-4  # torch's is Bessel's


@pytest.mark.parametrize("stride,groups,out", [(1, 8, 8), (2, 8, 16)])
def test_replk_block_and_its_fold_match_jax(stride, groups, out):
    """FastViT's block alone: a 7×7 and a 3×3 grouped conv + BN, summed (the
    downsampler's form: 8 → 16 channels, groups 8, stride 2); train and eval
    forward, and the fold against JAX's ``get_exportable_params``."""
    from cvnets_tpu.modules.mobileone_block import RepLKBlock as JaxRepLK
    from cvnets_tpu.utils.reparam_utils import get_exportable_params
    from cvnets_tpu_torch.modules.mobileone_block import RepLKBlock
    from cvnets_tpu_torch.utils.jax_params import load_jax_params
    from cvnets_tpu_torch.utils.reparam_utils import reparameterize_model

    opts_jax, opts_torch = both_opts(["--model.activation.name", "gelu"])
    x = np.random.default_rng(3).standard_normal((2, 12, 12, 8)).astype(np.float32)
    jblock = JaxRepLK(opts=opts_jax, channels=8, out_channels=out, stride=stride,
                      groups=groups)
    variables = perturbed_variables(jblock, x, seed=3)
    block = RepLKBlock(opts_torch, 8, out_channels=out, stride=stride, groups=groups)
    load_jax_params(block, variables["params"], variables["batch_stats"])
    for training in (False, True):  # eval first: a train forward moves the stats
        ref = jblock.apply(variables, jnp.asarray(x), training=training,
                           mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = block.train(training)(nchw(x))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-5)
    block = RepLKBlock(opts_torch, 8, out_channels=out, stride=stride, groups=groups)
    load_jax_params(block, variables["params"], variables["batch_stats"])
    exported = get_exportable_params(variables["params"], variables["batch_stats"])
    reparameterize_model(block.eval())
    folded = RepLKBlock(opts_torch, 8, out_channels=out, stride=stride, groups=groups,
                        inference_mode=True)
    load_jax_params(folded, exported)
    for a, b in zip(block.state_dict().values(), folded.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    ref = JaxRepLK(opts=opts_jax, channels=8, out_channels=out, stride=stride,
                   groups=groups, inference_mode=True).apply({"params": exported},
                                                             jnp.asarray(x))
    with torch.no_grad():
        got = block(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
