"""The port's ``make_train_step`` against the JAX ``make_train_step``
(cvnets_tpu/engine/train_state.py:111): float32 on the CPU, the same perturbed init
and the same uint8 batches, with AdamW, the no-decay mask, grad clip 10, EMA and
label smoothing 0.1; for MobileViTv2 at width 0.5, for the micro ViT (whose
positional table and CLS token take weight decay, as in the JAX mask) and for the
micro Swin with swin.yaml's clip 5 (its relative-position tables are rank 2 and
take weight decay too). And the
micro DeepLabv3 with deeplabv3_mobilevitv2.yaml's SGD, the seg head's LR ×10 and
the aux loss, whose bounds are explained above its tests.

Why the tolerances are what they are. Batch-statistic BN leaves the two frameworks'
grads ~1e-7 apart, and some grads are no larger than that: a bias whose shift the
next BN cancels has a true grad of ~0. Adam's first update is
g / (|g| + eps) ≈ sign(g), so those elements move by +lr in one framework and −lr
in the other, and from the second step on the two trajectories diverge like two
runs of one framework from states that differ by that much. (Measured: the JAX
step started from the port's step-1 state lands where the port does, not where JAX
from its own state does.) So:

* the first step, from one state, is checked tightly;
* three free-running steps are checked against the bounds Adam's step size sets;
* the optimizer, the clip and the EMA are checked tightly on identical grads.
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
    DEEPLAB_MICRO_ARGS,
    SMALL_MODEL_ARGS,
    SWIN_MICRO_ARGS,
    VIT_MICRO_ARGS,
    both_opts,
    micro_swin_modes,
    nchw,
    perturbed_variables,
    port_model_from,
    seg_targets,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

STEP_ARGS = [
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.05",
    "--optim.no-decay-bn-filter-bias",
    "--common.grad-clip", "10",
    "--ema.enable",
    "--ema.momentum", "0.1",  # large, so three steps move the EMA measurably
    "--scheduler.name", "cosine",
    "--scheduler.is-iteration-based",
    "--scheduler.max-iterations", "100",
    "--scheduler.warmup-iterations", "2",
    "--scheduler.warmup-init-lr", "1e-4",
    "--scheduler.cosine.max-lr", "0.002",
]
ARGS = SMALL_MODEL_ARGS + STEP_ARGS
N_STEPS = 3
BATCH = 8  # at batch 2 the deepest BNs see 8 values a channel and the noise grows


def _pairs(tree, state_dict):
    """(torch key, flax leaf in torch layout, port tensor) for every leaf."""
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(p.key for p in path)
        key = torch_key(path)
        yield key, to_torch_layout(path, np.asarray(leaf)), state_dict[key].numpy()


class _LossAndNorm:
    """JAX metric object that hands the step's (total) loss and grad norm back."""

    def batch_values(self, prediction, targets, extras):
        loss = extras["loss"]
        return (loss["total_loss"] if isinstance(loss, dict) else loss), extras["grad_norm"]


def _trajectories(args, seg=False):
    """N_STEPS steps of both packages from one perturbed init on one batch list;
    ``seg``: per-pixel labels and the model's LR multipliers."""
    from cvnets_tpu.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.models import get_model
    from cvnets_tpu.optim import build_optimizer
    from cvnets_tpu_torch.engine import train_state as port
    from cvnets_tpu_torch.loss import build_loss_fn as port_loss
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.optim import build_optimizer as port_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler

    opts_jax, opts_torch = both_opts(args)
    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 256, (BATCH, 64, 64, 3)).astype(np.uint8) for _ in range(N_STEPS)]
    ys = [seg_targets(rng, BATCH, 64) if seg else rng.integers(0, 13, (BATCH,))
          for _ in range(N_STEPS)]
    lrs = [build_scheduler(opts_torch).retrieve_lr(0, i) for i in range(N_STEPS)]

    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, xs[0].astype(np.float32) / 255.0)
    tx = build_optimizer(opts_jax, lr_multipliers=jmodel.get_lr_multipliers(opts_jax))
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0),
                               {"samples": jnp.zeros((1, 64, 64, 3))}, ema_enabled=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {}))
    state = state.replace(params=params, batch_stats=stats, ema_params=params,
                          ema_batch_stats=stats, opt_state=tx.init(params))
    jstep = jax.jit(make_train_step(jmodel, build_loss_fn(opts_jax), tx, opts_jax,
                                    {"out": _LossAndNorm()}))

    model = port_model_from(opts_torch, variables)
    mults = model.get_lr_multipliers(opts_torch) if seg else None
    tstate = port.create_train_state(model, port_optimizer(opts_torch, model, mults),
                                     ema_enabled=True)
    tstep = port.make_train_step(model, port_loss(opts_torch), opts_torch,
                                 build_metrics(opts_torch, ["loss", "grad_norm"]))

    out = {"lrs": lrs, "jax": [], "torch": []}
    for i in range(N_STEPS):
        state, metrics = jstep(state, {"samples": jnp.asarray(xs[i]),
                                       "targets": jnp.asarray(ys[i])},
                               lrs[i], jax.random.PRNGKey(0))
        tstate, tmetrics = tstep(tstate, {"samples": nchw(xs[i]),
                                          "targets": torch.from_numpy(ys[i])}, lrs[i])
        out["jax"].append((state, *[float(v) for v in metrics["out"]]))
        out["torch"].append((
            {k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() for k, v in tstate.ema.model.state_dict().items()},
            tmetrics["loss"]["loss"][0].item(), tmetrics["grad_norm"]["grad_norm"][0].item()))
    assert tstate.step == N_STEPS
    return out


@pytest.fixture(scope="module")
def runs():
    return _trajectories(ARGS)


@pytest.fixture(scope="module")
def vit_runs():
    return _trajectories(VIT_MICRO_ARGS + STEP_ARGS)


@pytest.fixture(scope="module")
def swin_runs():
    with micro_swin_modes():
        return _trajectories(SWIN_MICRO_ARGS + STEP_ARGS + ["--common.grad-clip", "5"])


# deeplabv3_mobilevitv2.yaml's optimizer and schedule: SGD with momentum 0.9,
# coupled weight decay 1e-4 off rank-1 tensors, the seg head's LR ×10, clip 10,
# EMA (momentum raised so that three steps move it), warmup from 9e-4 over 500
# iterations to a cosine from 0.02
SEG_STEP_ARGS = [
    "--model.segmentation.output-stride", "16",
    "--model.segmentation.lr-multiplier", "10",
    "--optim.name", "sgd",
    "--optim.sgd.momentum", "0.9",
    "--optim.weight-decay", "1e-4",
    "--optim.no-decay-bn-filter-bias",
    "--common.grad-clip", "10",
    "--ema.enable",
    "--ema.momentum", "0.1",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "120",
    "--scheduler.warmup-iterations", "500",
    "--scheduler.warmup-init-lr", "9e-4",
    "--scheduler.cosine.max-lr", "0.02",
    "--scheduler.cosine.min-lr", "2e-4",
]


@pytest.fixture(scope="module")
def seg_runs():
    return _trajectories(DEEPLAB_MICRO_ARGS + SEG_STEP_ARGS, seg=True)


def test_first_step_matches_jax(runs):
    _check_first_step(runs)


def test_three_steps_stay_within_adams_bounds(runs):
    _check_three_steps(runs)


# The micro ViT has BN only in its conv stem, so its grads carry less noise: no
# sign flips at step 1 (measured max 0.7% of lr) and 0.14% of Σlr after three
# steps. The shared bounds hold it with room.
def test_vit_first_step_matches_jax(vit_runs):
    _check_first_step(vit_runs)


def test_vit_three_steps_stay_within_adams_bounds(vit_runs):
    _check_three_steps(vit_runs)


# The micro Swin has no BN at all, so the shared bounds hold it with more room
# than the ViT's.
def test_swin_first_step_matches_jax(swin_runs):
    _check_first_step(swin_runs)


def test_swin_three_steps_stay_within_adams_bounds(swin_runs):
    _check_three_steps(swin_runs)


# DeepLabv3 with SGD. An SGD step moves an element by lr·mult·(clipped g + decay),
# so the two packages' params part by lr·mult times their grads' difference. At
# one state those grads differ by float32 noise that batch-statistic BN amplifies
# most in the stem: 5.5e-3 of the largest grad for JAX against float64
# (test_torch_deeplabv3.py), measured 0.1% in the grad norm and 0.028·lr in the
# params after step 1. From step 2 the stem's grads react to that 4e-5 relative
# difference of the weights: the grad norms part by 3.6% at step 2 while the
# losses agree to 6e-5 and the params to 0.07·Σlr after step 3 (measured). The
# update rule itself is checked without that noise on identical grads below.
def test_deeplabv3_first_sgd_step_matches_jax(seg_runs):
    (state, jloss, jnorm), (sd, ema_sd, loss, norm) = seg_runs["jax"][0], seg_runs["torch"][0]
    lr = seg_runs["lrs"][0]
    assert loss == pytest.approx(jloss, abs=1e-5)
    assert norm == pytest.approx(jnorm, rel=5e-3)
    for key, want, got in _pairs(state.batch_stats, sd):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max(),
                                   err_msg=key)
    for key, want, got in _pairs(state.params, sd):
        np.testing.assert_allclose(got, want, rtol=0, atol=0.1 * lr, err_msg=key)
    for key, want, got in _pairs(state.ema_params, ema_sd):  # 0.1 of the step
        np.testing.assert_allclose(got, want, rtol=0, atol=0.01 * lr, err_msg=key)


def test_deeplabv3_three_sgd_steps_stay_close_to_jax(seg_runs):
    total_lr = sum(seg_runs["lrs"])
    for i, ((_, jloss, jnorm), (_, _, loss, norm)) in enumerate(zip(seg_runs["jax"],
                                                                   seg_runs["torch"])):
        assert loss == pytest.approx(jloss, abs=1e-3), f"step {i}"
        assert norm == pytest.approx(jnorm, rel=0.1), f"step {i}"
    state, (sd, ema_sd, _, _) = seg_runs["jax"][-1][0], seg_runs["torch"][-1]
    for key, want, got in _pairs(state.params, sd):
        np.testing.assert_allclose(got, want, rtol=0, atol=0.2 * total_lr, err_msg=key)
    for key, want, got in _pairs(state.ema_params, ema_sd):
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * total_lr, err_msg=key)
    for tree, port_sd in ((state.batch_stats, sd), (state.ema_batch_stats, ema_sd)):
        for key, want, got in _pairs(tree, port_sd):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-2 * max(1.0, np.abs(want).max()),
                                       err_msg=key)


def test_clip_sgd_lr_multiplier_and_ema_match_jax_on_the_same_grads():
    """Noise-free check of the SGD update: identical synthetic grads through the
    clip, SGD with momentum and masked coupled decay, the seg head's LR ×10 and
    the EMA of both packages, for three steps (the momentum buffer starts at the
    first grad in both)."""
    import optax

    from cvnets_tpu.misc.averaging_utils import ema_update
    from cvnets_tpu.models import get_model
    from cvnets_tpu.optim import build_optimizer
    from cvnets_tpu_torch.engine.train_state import clip_grad_norm_
    from cvnets_tpu_torch.misc.averaging_utils import EMA
    from cvnets_tpu_torch.optim import build_optimizer as port_optimizer

    opts_jax, opts_torch = both_opts(DEEPLAB_MICRO_ARGS + SEG_STEP_ARGS)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, np.zeros((2, 64, 64, 3), np.float32))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    model = port_model_from(opts_torch, variables)
    mults = model.get_lr_multipliers(opts_torch)
    assert mults == jmodel.get_lr_multipliers(opts_jax) == {"seg_head": 10.0}
    opt, ema = port_optimizer(opts_torch, model, mults), EMA(model)
    assert sorted((g["weight_decay"], g["lr_mult"]) for g in opt.param_groups) == [
        (0.0, 1.0), (0.0, 10.0), (1e-4, 1.0), (1e-4, 10.0)]
    named = dict(model.named_parameters())
    tx = build_optimizer(opts_jax, lr_multipliers=mults)
    opt_state, ema_params = tx.init(params), params

    rng = np.random.default_rng(5)
    clip = 0.4
    for lr in (1e-2, 2e-2, 3e-2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(1e-3 * rng.standard_normal(p.shape), jnp.float32),
            params)
        norm = optax.global_norm(grads)
        scale = jnp.minimum(1.0, clip / (norm + 1e-6))
        assert float(scale) < 0.5  # the clip is active
        opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, opt_state = tx.update(jax.tree_util.tree_map(lambda g: g * scale, grads),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        ema_params = ema_update(ema_params, params, 0.1)

        for key, g, _ in _pairs(grads, model.state_dict()):
            named[key].grad = torch.from_numpy(np.array(g))
        port_norm = clip_grad_norm_(list(model.parameters()), clip)
        assert port_norm.item() == pytest.approx(float(norm), rel=1e-6)
        for group in opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
        opt.step()
        ema.update(model, 0.1)

    # float32 rounding of the same arithmetic on values ~1
    for tree, port_model in ((params, model), (ema_params, ema.model)):
        for key, want, got in _pairs(tree, port_model.state_dict()):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)


def _check_first_step(runs):
    (state, jloss, jnorm), (sd, ema_sd, loss, norm) = runs["jax"][0], runs["torch"][0]
    lr = runs["lrs"][0]
    assert loss == pytest.approx(jloss, abs=1e-5)
    # the grads carry the BN-amplified noise bounded in test_torch_mobilevit_v2
    assert norm == pytest.approx(jnorm, rel=5e-4)
    # one train forward from one state: the BN-stat bound of test_torch_mobilevit_v2
    for key, want, got in _pairs(state.batch_stats, sd):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max(),
                                   err_msg=key)
    # Adam's first step is ±lr per element: agreement to 1% of lr except where the
    # sign of a noise-level grad flipped (measured 0.12% of elements), and never
    # more than the 2·lr of a flip
    diffs = np.concatenate([np.abs(got - want).ravel()
                            for _, want, got in _pairs(state.params, sd)])
    assert diffs.max() <= 2.0001 * lr
    assert np.mean(diffs > 1e-2 * lr) < 0.01
    # EMA = 0.9·p0 + 0.1·p1 carries a tenth of those differences
    diffs = np.concatenate([np.abs(got - want).ravel()
                            for _, want, got in _pairs(state.ema_params, ema_sd)])
    assert diffs.max() <= 0.2001 * lr
    assert np.mean(diffs > 1e-3 * lr) < 0.01


def _check_three_steps(runs):
    total_lr = sum(runs["lrs"])
    for i, ((_, jloss, jnorm), (_, _, loss, norm)) in enumerate(zip(runs["jax"],
                                                                   runs["torch"])):
        # measured drift by step 3: 3e-4 in the loss, 4e-3 relative in the norm
        assert loss == pytest.approx(jloss, abs=5e-3), f"step {i}"
        assert norm == pytest.approx(jnorm, rel=2e-2), f"step {i}"
    state, (sd, ema_sd, _, _) = runs["jax"][-1][0], runs["torch"][-1]
    # Adam moves an element by at most ~lr a step, so two trajectories that
    # differ only by noise stay within 2·Σlr (measured max 1.5·Σlr)
    for key, want, got in _pairs(state.params, sd):
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * total_lr, err_msg=key)
    for key, want, got in _pairs(state.ema_params, ema_sd):
        np.testing.assert_allclose(got, want, rtol=0, atol=0.2 * 2 * total_lr,
                                   err_msg=key)
    # running stats follow the diverged params (measured max 3.7e-3 on values ~1)
    for tree, port_sd in ((state.batch_stats, sd), (state.ema_batch_stats, ema_sd)):
        for key, want, got in _pairs(tree, port_sd):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-2 * max(1.0, np.abs(want).max()),
                                       err_msg=key)


def test_clip_adamw_and_ema_match_jax_on_the_same_grads():
    """Noise-free check of the update rule: identical synthetic grads through the
    clip (train_state.py:232-235), the masked AdamW and the EMA of both packages.
    eps is set near the grads' size so that the clip scale, which Adam would
    otherwise cancel, shows in the update."""
    import optax

    from cvnets_tpu.misc.averaging_utils import ema_update
    from cvnets_tpu.models import get_model
    from cvnets_tpu.optim import build_optimizer
    from cvnets_tpu_torch.engine.train_state import clip_grad_norm_
    from cvnets_tpu_torch.misc.averaging_utils import EMA
    from cvnets_tpu_torch.optim import build_optimizer as port_optimizer

    opts_jax, opts_torch = both_opts(ARGS + ["--optim.eps", "1e-3"])
    x = np.zeros((1, 64, 64, 3), np.float32)
    variables = perturbed_variables(get_model(opts_jax), x)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    model = port_model_from(opts_torch, variables)
    named = dict(model.named_parameters())
    opt, ema = port_optimizer(opts_torch, model), EMA(model)
    tx = build_optimizer(opts_jax)
    opt_state, ema_params = tx.init(params), params

    rng = np.random.default_rng(5)
    clip = 0.4
    for lr in (1e-3, 2e-3, 3e-3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(1e-3 * rng.standard_normal(p.shape), jnp.float32),
            params)
        norm = optax.global_norm(grads)  # ~1.05 for 1.1M grads of size 1e-3
        scale = jnp.minimum(1.0, clip / (norm + 1e-6))
        assert float(scale) < 0.5  # the clip is active
        opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, opt_state = tx.update(jax.tree_util.tree_map(lambda g: g * scale, grads),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        ema_params = ema_update(ema_params, params, 0.1)

        for key, g, _ in _pairs(grads, model.state_dict()):
            named[key].grad = torch.from_numpy(np.array(g))
        port_norm = clip_grad_norm_(list(model.parameters()), clip)
        assert port_norm.item() == pytest.approx(float(norm), rel=1e-6)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        ema.update(model, 0.1)

    # float32 rounding of the same arithmetic on values ~1
    for tree, port_model in ((params, model), (ema_params, ema.model)):
        for key, want, got in _pairs(tree, port_model.state_dict()):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)
