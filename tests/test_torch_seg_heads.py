"""The segmentation heads and layers that DeepLabv3's ASPP did not need, in the
PyTorch port against the JAX package on the same weights, float32 on the CPU:

* ``adaptive_avg_pool_2d`` (the JAX windows, not ``F.adaptive_avg_pool2d``'s),
  ``MaxPool2d`` and ``AvgPool2d`` against flax's pools;
* PSPNet, DeepLabv3 with the separable ASPP and the simple head, each on a
  MobileNetV2-0.25 encoder (ade20k/deeplabv3_mobilenetv2.yaml's) at output
  stride 8 (an 8 × 8 map at 64 px, where pool sizes 3 and 6 do not divide
  it), 13 classes, a 32-channel head, the aux head, dropouts 0, batch 2: the
  train-mode head-resolution outputs, the BN running statistics after that
  forward, the loss dict and every parameter's grad through it, with the flax
  tree of each head (``psp/psp_branch_<i>``, ``psp/fusion``,
  ``aspp/aspp_sep_<i>/{dw_conv,pw_conv}``, ``conv``) loaded by
  ``load_jax_params`` (which also shows that the port's encoder has no
  ``conv_1x1_exp`` here, as the flax tree has none);
* ``--model.segmentation.freeze-batch-norm``: two SGD steps with weight decay
  on every tensor (and clip 1) of DeepLabv3 with the separable ASPP on the same
  encoder leave every norm scale, bias and running statistic where it was in
  both packages (the JAX regex's norm leaves are the ones the port's optimizer
  leaves out), the rest moving as JAX's: within 1e-4 of the LR (measured
  1.3e-5; with BN on running statistics the float32 noise is not amplified).

Tolerances. Train-mode grads through batch-statistic BNs are chaotic in
float32 (ROADMAP.md queue 3, "Conv-family parity"): the two packages' grads
of these models lie up to 2.8e-3 of the largest grad apart (measured on a
ResNet-18 encoder), in the heads as much as in the encoder. So both packages
run the models in float64 (``jax_in_float64``; the CE stays float32 in both),
where they agree to ~1e-7 of the largest grad (measured); held at 1e-5 of the
largest grad, outputs and BN statistics at 1e-6 of their largest value, the
loss at 1e-5 (a float32 sum over the pixels, as test_torch_deeplabv3.py).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    both_opts,
    flat_leaves,
    jax_in_float64,
    nchw,
    perturbed_variables,
    port_model_from,
    seg_targets,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

SEG_ARGS = [
    "--dataset.category", "segmentation",
    "--model.segmentation.name", "encoder_decoder",
    "--model.segmentation.n-classes", "13",
    "--model.segmentation.use-aux-head",
    "--model.segmentation.output-stride", "8",
    "--model.segmentation.classifier-dropout", "0",
    "--model.segmentation.aux-dropout", "0",
    "--model.segmentation.pspnet.psp-out-channels", "32",
    "--model.segmentation.pspnet.psp-dropout", "0",
    "--model.segmentation.deeplabv3.aspp-out-channels", "32",
    "--model.segmentation.deeplabv3.aspp-dropout", "0",
    "--model.classification.name", "mobilenetv2",
    "--model.classification.mobilenetv2.width-multiplier", "0.25",
    "--model.activation.name", "relu",
    "--model.layer.conv-init", "kaiming_normal",
    "--loss.category", "segmentation",
    "--loss.segmentation.name", "cross_entropy",
    "--loss.segmentation.cross-entropy.aux-weight", "0.4",
]
HEADS = {
    "pspnet": ["--model.segmentation.seg-head", "pspnet"],
    "deeplabv3_sep": ["--model.segmentation.seg-head", "deeplabv3",
                      "--model.segmentation.deeplabv3.aspp-sep-conv"],
    "simple_seg_head": ["--model.segmentation.seg-head", "simple_seg_head"],
}
OUT_REL, LOSS_ATOL, GRAD_REL = 1e-6, 1e-5, 1e-5


@pytest.mark.parametrize("size,out", [((32, 32), (1, 1)), ((32, 32), (2, 2)),
                                      ((32, 32), (3, 3)), ((32, 32), (6, 6)),
                                      ((20, 13), (3, 6)), ((64, 48), (6, 3))])
def test_adaptive_avg_pool_takes_the_jax_windows(size, out):
    from cvnets_tpu.layers.pool import adaptive_avg_pool_2d as jax_pool
    from cvnets_tpu_torch.layers.pool import adaptive_avg_pool_2d

    x = np.random.default_rng(0).standard_normal((2, *size, 5)).astype(np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x), out)).transpose(0, 3, 1, 2)
    got = adaptive_avg_pool_2d(nchw(x), out).numpy()
    assert got.shape == want.shape == (2, 5, *out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if size == (32, 32) and out[0] in (3, 6):  # torch's own windows differ here
        torch_windows = torch.nn.functional.adaptive_avg_pool2d(nchw(x), out).numpy()
        assert np.abs(torch_windows - want).max() > 1e-3


@pytest.mark.parametrize("kind,kernel,stride,padding", [("max", 3, 2, 1), ("avg", 2, 2, 0),
                                                        ("avg", 3, 2, 1)])
def test_max_and_avg_pool_match_flax(kind, kernel, stride, padding):
    from cvnets_tpu.layers.pool import AvgPool2d as JaxAvg, MaxPool2d as JaxMax
    from cvnets_tpu_torch.layers.pool import AvgPool2d, MaxPool2d

    x = np.random.default_rng(1).standard_normal((2, 11, 10, 3)).astype(np.float32)
    jcls, pcls = (JaxMax, MaxPool2d) if kind == "max" else (JaxAvg, AvgPool2d)
    jmod = jcls(kernel_size=kernel, stride=stride, padding=padding)
    want = np.asarray(jmod.apply({}, jnp.asarray(x))).transpose(0, 3, 1, 2)
    got = pcls(kernel, stride, padding)(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _jax_train(jmodel, variables, opts_jax, x, y):
    """The JAX model's train outputs, new BN statistics, loss dict and grads."""
    from cvnets_tpu.loss import build_loss_fn

    crit = build_loss_fn(opts_jax)

    def loss_fn(params):
        pred, new = jmodel.apply({**variables, "params": params}, jnp.asarray(x),
                                 training=True, mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        losses = crit(None, pred, jnp.asarray(y), training=True)
        return losses["total_loss"], (pred, new, losses)

    (_, (pred, new, losses)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return as_np(pred), as_np(new["batch_stats"]), as_np(losses), as_np(grads)


@pytest.fixture(scope="module", params=list(HEADS))
def head_pair(request):
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(SEG_ARGS + HEADS[request.param])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = seg_targets(rng, 2, 64)
    variables = perturbed_variables(get_model(opts_jax), x)
    with jax_in_float64(opts_jax):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        want = _jax_train(get_model(opts_jax), v64, opts_jax, x.astype(np.float64), y)
    model = port_model_from(opts_torch, variables).double().train()
    from cvnets_tpu_torch.loss import build_loss_fn

    pred = model(nchw(x.astype(np.float64)))
    losses = build_loss_fn(opts_torch)(None, pred, torch.from_numpy(y), training=True)
    losses["total_loss"].backward()
    return dict(head=request.param, variables=variables, want=want, model=model,
                pred={k: v.detach() for k, v in pred.items()}, losses=losses)


def test_head_scopes_are_the_flax_ones(head_pair):
    params = head_pair["variables"]["params"]["seg_head"]
    scopes = {"pspnet": {"psp/psp_branch_0", "psp/psp_branch_3", "psp/fusion"},
              "deeplabv3_sep": {"aspp/aspp_sep_0/dw_conv", "aspp/aspp_sep_2/pw_conv"},
              "simple_seg_head": {"conv"}}[head_pair["head"]]
    paths = {"/".join(p[:-2]) for p, _ in flat_leaves(params)}
    assert scopes <= paths, sorted(paths)


def test_train_outputs_and_bn_stats_match(head_pair):
    from cvnets_tpu_torch.utils.jax_params import torch_key

    pred, stats, _, _ = head_pair["want"]
    assert set(head_pair["pred"]) == set(pred) == {"segmentation_output", "aux_output"}
    for key, got in head_pair["pred"].items():
        assert tuple(got.shape) == (2, 13, 8, 8), key
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), pred[key], rtol=0,
                                   atol=OUT_REL * np.abs(pred[key]).max(), err_msg=key)
    state = head_pair["model"].state_dict()
    leaves = list(flat_leaves(stats))
    assert any(path[0] == "seg_head" for path, _ in leaves)
    for path, leaf in leaves:
        key = torch_key(path)
        np.testing.assert_allclose(state[key].numpy(), leaf, rtol=0,
                                   atol=OUT_REL * float(np.abs(leaf).max()), err_msg=key)


def test_loss_dict_and_param_grads_match(head_pair):
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    _, _, jlosses, jgrads = head_pair["want"]
    for key, value in head_pair["losses"].items():
        assert value.item() == pytest.approx(float(jlosses[key]), abs=LOSS_ATOL), key
    named = dict(head_pair["model"].named_parameters())
    leaves = list(flat_leaves(jgrads))
    assert len(leaves) == len(named)
    gmax = max(float(np.abs(g).max()) for _, g in leaves)
    for path, g in leaves:
        key = torch_key(path)
        np.testing.assert_allclose(named[key].grad.numpy(), to_torch_layout(path, g),
                                   rtol=0, atol=GRAD_REL * gmax, err_msg=key)


FROZEN_ARGS = SEG_ARGS + HEADS["deeplabv3_sep"][:2] + [
    "--model.segmentation.freeze-batch-norm",
    "--optim.name", "sgd",
    "--optim.sgd.momentum", "0.9",
    "--optim.weight-decay", "0.01",  # on every tensor: a norm scale would move
    "--common.grad-clip", "1",
]
FROZEN_LR, FROZEN_STEPS = 0.05, 2


@pytest.fixture(scope="module")
def frozen_runs():
    """FROZEN_STEPS SGD steps of both packages from one perturbed init."""
    from cvnets_tpu.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu.layers.normalization import NORM_PARAM_FREEZE_REGEX
    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.models import get_model
    from cvnets_tpu.optim import build_optimizer
    from cvnets_tpu_torch.engine import train_state as port
    from cvnets_tpu_torch.loss import build_loss_fn as port_loss
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.optim import build_optimizer as port_optimizer

    opts_jax, opts_torch = both_opts(FROZEN_ARGS)
    rng = np.random.default_rng(3)
    xs = [rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8) for _ in range(FROZEN_STEPS)]
    ys = [seg_targets(rng, 2, 64) for _ in range(FROZEN_STEPS)]
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, xs[0].astype(np.float32) / 255.0)
    tx = build_optimizer(opts_jax)
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0),
                               {"samples": jnp.zeros((1, 64, 64, 3))})
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    state = state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
    jstep = jax.jit(make_train_step(jmodel, build_loss_fn(opts_jax), tx, opts_jax, {}))

    model = port_model_from(opts_torch, variables)
    tstate = port.create_train_state(model, port_optimizer(opts_torch, model))
    tstep = port.make_train_step(model, port_loss(opts_torch), opts_torch,
                                 build_metrics(opts_torch, ["loss"]))
    for x, y in zip(xs, ys):
        state, _ = jstep(state, {"samples": jnp.asarray(x), "targets": jnp.asarray(y)},
                         FROZEN_LR, jax.random.PRNGKey(0))
        tstate, _ = tstep(tstate, {"samples": nchw(x), "targets": torch.from_numpy(y)},
                          FROZEN_LR)
    import re

    jax_frozen = {path for path, _ in flat_leaves(variables["params"])
                  if re.search(NORM_PARAM_FREEZE_REGEX, "/".join(path))}
    return dict(variables=variables, state=state, model=model, jax_frozen=jax_frozen,
                opt=tstate.optimizer)


def test_frozen_norms_and_statistics_stay_and_the_rest_moves_as_in_jax(frozen_runs):
    from cvnets_tpu_torch.layers.normalization import FrozenBatchNorm2d
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    run = frozen_runs
    model, state, variables = run["model"], run["state"], run["variables"]
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(isinstance(m, FrozenBatchNorm2d) for m in bns)
    sd = model.state_dict()
    in_optimizer = {id(p) for group in run["opt"].param_groups for p in group["params"]}
    named = dict(model.named_parameters())
    assert run["jax_frozen"]
    for path, leaf in flat_leaves(variables["params"]):
        key = torch_key(path)
        want = np.asarray(jax.tree_util.tree_reduce(
            lambda a, b: b, {"x": _leaf(state.params, path)}))
        if path in run["jax_frozen"]:  # the norm affines: where they started, both sides
            np.testing.assert_array_equal(want, leaf, err_msg=key)
            np.testing.assert_array_equal(sd[key].numpy(), to_torch_layout(path, leaf),
                                          err_msg=key)
            assert id(named[key]) not in in_optimizer, key
        else:
            assert id(named[key]) in in_optimizer, key
            assert not np.array_equal(want, leaf), key  # it moved
            np.testing.assert_allclose(sd[key].numpy(), to_torch_layout(path, want),
                                       rtol=0, atol=1e-4 * FROZEN_LR, err_msg=key)
    for path, leaf in flat_leaves(variables["batch_stats"]):  # never updated
        np.testing.assert_array_equal(np.asarray(_leaf(state.batch_stats, path)), leaf)
        np.testing.assert_array_equal(sd[torch_key(path)].numpy(), leaf)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree
