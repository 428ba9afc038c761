"""DeepLabv3-MobileViTv2 in the PyTorch port against the JAX package on the same
weights: MobileViTv2 at width 0.5, a 32-channel ASPP, 13 classes, the aux head,
dropouts 0, 64 px, batch 2, float32 on the CPU, at output strides 16 and 8.
Checked: the train-mode head-resolution ``segmentation_output`` and
``aux_output``, the eval logits upsampled to 64², the BN running statistics after
one train forward, the loss dict of ``SegCrossEntropy`` (aux weight 0.4) and
every parameter's gradient through it. The flax tree of the whole model
(``encoder/…``, ``seg_head/aspp/aspp_rate_0/…``) fills the port's model by the
loader's existing rule.

Tolerances. Eval logits and BN statistics keep test_torch_mobilevit_v2.py's
bounds. Train mode runs every BN on batch statistics, which amplifies float32
noise layer by layer (test_torch_mobilevit_v2.py's docstring); the classifier
there averages it away in a global pool, a segmentation head does not. Measured
here at OS 16: the head outputs differ by 7.8e-5 of their largest value (bound
2e-4); the undilated encoder's own layer_5 output already differs by 2.6e-4 of
its largest value. The grads are held leaf by leaf. Against the port's float64
grads on the same inputs (a measurement, not part of the test), JAX's float32
grads are the noisier: 5.5e-3 of the largest grad off at the stem, at the end
of the longest backward path through batch-statistic BNs (the port's float32
grads: 1.4e-3), and up to 2.2e-2 of a leaf's own largest grad in the encoder's
middle (the port's: 1.4e-3), rising to 22% in leaves whose grads are below
3e-4 of the largest. The JAX package computes in float32 whatever its input
dtype, so a float64 comparison is not open. Each element is held to the
smaller of 1e-2 of the largest grad and 3e-2 of its leaf's largest grad plus
2e-4 of the largest grad (measured: at most 0.70 of that bound), so a leaf that
is wrong through and through fails unless its grads are below 2e-4 of the
largest. Those few (the transformer's pre-FFN norms, the BN biases whose grad
is zero up to rounding) are held as a whole: the port's grad of each leaf
whose grads reach 2e-6 of the largest is within 1e-1 of JAX's in L2 norm
(measured: at most 4.5e-2, where JAX's float32 noise is largest); the
zero-grad BN biases stay below 2.5e-7 of the largest and every other leaf is
above 1e-5."""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    DEEPLAB_MICRO_ARGS,
    both_opts,
    nchw,
    perturbed_variables,
    port_model_from,
    seg_targets,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

LOGIT_ATOL = 1e-4  # eval: no batch statistics
TRAIN_OUT_REL = 2e-4  # train-mode outputs, of the largest
GRAD_REL = 1e-2  # of the largest grad
LEAF_REL, GRAD_FLOOR = 3e-2, 2e-4  # of the leaf's largest grad, plus of the largest
LEAF_L2_REL = 1e-1  # a leaf's grad as a whole, in L2 norm


@pytest.fixture(scope="module", params=[16, 8], ids=["os16", "os8"])
def pair(request):
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(DEEPLAB_MICRO_ARGS + [
        "--model.segmentation.output-stride", str(request.param)])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = seg_targets(rng, 2, 64)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    return dict(x=x, y=y, jmodel=jmodel, variables=variables, opts_jax=opts_jax,
                opts_torch=opts_torch, os=request.param)


def _train_apply(pair, params=None):
    variables = pair["variables"]
    if params is not None:
        variables = {**variables, "params": params}
    return pair["jmodel"].apply(variables, jnp.asarray(pair["x"]), training=True,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})


def test_train_outputs_and_bn_stats_match(pair):
    from cvnets_tpu_torch.utils.jax_params import torch_key

    ref, new_vars = _train_apply(pair)
    model = port_model_from(pair["opts_torch"], pair["variables"]).train()
    with torch.no_grad():
        out = model(nchw(pair["x"]))
    head = 64 // pair["os"]
    assert set(out) == {"segmentation_output", "aux_output"}
    for key, got in out.items():
        assert tuple(got.shape) == (2, 13, head, head), key
        want = np.asarray(ref[key])
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                                   atol=TRAIN_OUT_REL * np.abs(want).max(), err_msg=key)
    state = model.state_dict()
    stats = jax.tree_util.tree_flatten_with_path(new_vars["batch_stats"])[0]
    assert any(p[0].key == "seg_head" for p, _ in stats)
    for path, leaf in stats:
        key = torch_key(tuple(p.key for p in path))
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(state[key].numpy(), leaf, rtol=0,
                                   atol=2e-4 * float(np.abs(leaf).max()), err_msg=key)


def test_eval_logits_are_upsampled_and_match(pair):
    ref = pair["jmodel"].apply(pair["variables"], jnp.asarray(pair["x"]), training=False)
    model = port_model_from(pair["opts_torch"], pair["variables"]).eval()
    with torch.no_grad():
        out = model(nchw(pair["x"]))
    assert tuple(out.shape) == (2, 13, 64, 64)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL, rtol=0)


def test_loss_dict_and_param_grads_match(pair):
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu_torch.loss import build_loss_fn as torch_loss
    from cvnets_tpu_torch.utils.jax_params import torch_key

    x, y = jnp.asarray(pair["x"]), jnp.asarray(pair["y"])
    jcrit = jax_loss(pair["opts_jax"])

    def loss_fn(params):
        pred, _ = _train_apply(pair, params)
        losses = jcrit(x, pred, y, training=True)
        return losses["total_loss"], losses

    (_, jlosses), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        pair["variables"]["params"])

    model = port_model_from(pair["opts_torch"], pair["variables"]).train()
    losses = torch_loss(pair["opts_torch"])(None, model(nchw(pair["x"])),
                                            torch.from_numpy(pair["y"]), training=True)
    losses["total_loss"].backward()
    assert set(losses) == set(jlosses) == {"total_loss", "seg_loss", "aux_loss"}
    for key, value in losses.items():
        assert value.item() == pytest.approx(float(jlosses[key]), abs=1e-5), key

    named = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(named)
    gmax = max(float(np.abs(np.asarray(g)).max()) for _, g in flat)
    for path, g in flat:
        key = torch_key(tuple(p.key for p in path))
        g = np.asarray(g)
        g = g.transpose(3, 2, 0, 1) if g.ndim == 4 else (g.T if g.ndim == 2 else g)
        got = named[key].grad.numpy()
        atol = min(GRAD_REL * gmax, LEAF_REL * np.abs(g).max() + GRAD_FLOOR * gmax)
        np.testing.assert_allclose(got, g, rtol=0, atol=atol, err_msg=key)
        if np.abs(g).max() > 2e-6 * gmax:
            l2 = np.linalg.norm(got - g) / np.linalg.norm(g)
            assert l2 <= LEAF_L2_REL, (key, l2)


def test_full_resolution_logits_take_the_unfused_ce(pair):
    """``--model.segmentation.upsample-train-logits``: the model upsamples in
    training too and the loss takes the plain CE at the labels' size
    (segmentation.py:76-91), with label smoothing and class weights."""
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.loss import build_loss_fn as torch_loss
    from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

    extra = ["--model.segmentation.upsample-train-logits",
             "--loss.segmentation.cross-entropy.label-smoothing", "0.1",
             "--loss.segmentation.cross-entropy.class-weights"]
    args = DEEPLAB_MICRO_ARGS + ["--model.segmentation.output-stride", str(pair["os"])]
    opts_jax, opts_torch = jax_args(args=args + extra), torch_args(args=args + extra)
    jmodel = type(pair["jmodel"])(opts=opts_jax)
    ref, _ = jmodel.apply(pair["variables"], jnp.asarray(pair["x"]), training=True,
                          mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    jlosses = jax_loss(opts_jax)(None, ref, jnp.asarray(pair["y"]))
    model = port_model_from(opts_torch, pair["variables"]).train()
    with torch.no_grad():
        out = model(nchw(pair["x"]))
        losses = torch_loss(opts_torch)(None, out, torch.from_numpy(pair["y"]))
    assert tuple(out["segmentation_output"].shape) == (2, 13, 64, 64)
    for key, value in losses.items():  # ~25: the class weights are ~10
        assert value.item() == pytest.approx(float(jlosses[key]), rel=1e-5), key


def test_seg_flags_and_yaml_parse_to_the_same_values():
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

    args = ["--common.config-file", "config/segmentation/ade20k/deeplabv3_mobilevitv2.yaml"]
    jax_opts, torch_opts = jax_args(args=args), torch_args(args=args)
    for dest, value in vars(torch_opts).items():
        assert getattr(jax_opts, dest) == value, dest
    for dest, value in (("model.segmentation.n_classes", 150),
                        ("model.segmentation.lr_multiplier", 10),
                        ("model.segmentation.deeplabv3.aspp_rates", [6, 12, 18]),
                        ("model.segmentation.deeplabv3.aspp_out_channels", 512),
                        ("loss.segmentation.cross_entropy.aux_weight", 0.4),
                        ("optim.sgd.momentum", 0.9), ("optim.weight_decay", 1e-4)):
        assert getattr(torch_opts, dest) == value, dest


def test_unported_options_raise_and_name_themselves(tmp_path):
    """The separable ASPP, PSPNet and frozen BN are ported (test_torch_seg_heads.py);
    what stays unported on this path raises naming itself: each segmentation
    transform that no yaml of config/segmentation/ turns on, when a training
    set is built, and a seg head that is not registered."""
    from cvnets_tpu_torch.data.datasets import build_dataset_from_registry
    from cvnets_tpu_torch.data.transforms.image import UNPORTED_SEGMENTATION_TRANSFORMS
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.logger import LoggerError

    args = DEEPLAB_MICRO_ARGS + ["--model.segmentation.output-stride", "16",
                                 "--dataset.name", "ade20k", "--dataset.root-train",
                                 str(tmp_path)]
    for dest in UNPORTED_SEGMENTATION_TRANSFORMS:
        flag = "--" + dest.replace("_", "-")
        _, opts = both_opts(args + [flag])
        with pytest.raises(NotImplementedError, match=flag.replace(".", r"\.")):
            build_dataset_from_registry(opts, is_training=True)
        build_dataset_from_registry(opts, is_training=False)  # validation has none
    _, opts = both_opts(args + ["--model.segmentation.seg-head", "fcn"])
    with pytest.raises(LoggerError, match="fcn"):
        get_model(opts, device="cpu")
