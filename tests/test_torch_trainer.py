"""The port's engine against the JAX package's, float32 on the CPU:

* one micro-MobileViTv2 step at ``--common.accum-freq 2`` against the JAX step
  (cvnets_tpu/engine/train_state.py:195-226): the grads (the mean over the two
  micro-batches, read from the JAX AdamW's first moment), the params after
  AdamW, the BN running statistics (one update from the last micro-batch, bit
  for bit what that micro-batch alone gives) and the loss metric (the last
  micro-batch's);
* a step with an annealed BN momentum against the JAX re-blend (:205-216);
* the port's ``Trainer`` against the JAX ``Trainer``: 2 epochs of 2 iterations
  at batch 8 from the JAX state's weights, per-epoch train loss and grad norm,
  val and EMA val loss, top-1 and top-5;
* the Trainer's own control: the step without accumulation before
  ``--common.accum-after-epoch``, read-backs only at log points and at the end
  of an epoch, and the features it refuses.

Tolerances follow tests/test_torch_train_step.py's docstring: batch-statistic BN
leaves the two frameworks' grads ~1e-7 apart, Adam's first step turns that into
±lr on elements whose grad is noise-sized, so params are held to Adam's bounds,
grads to 5e-4 of the largest grad, BN statistics to 2e-4 of their largest value.
"""

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
    SMALL_MODEL_ARGS,
    both_opts,
    nchw,
    perturbed_variables,
    port_model_from,
    torch_threads,
    uint8_batches,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

ACCUM_ARGS = SMALL_MODEL_ARGS + [
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.05",
    "--optim.no-decay-bn-filter-bias",
    "--common.grad-clip", "10",
    "--common.accum-freq", "2",
]
ACCUM_BATCH = 16  # two micro-batches of 8, the batch test_torch_train_step holds
LR = 1e-3


def _pairs(tree, state_dict):
    """(torch key, flax leaf in torch layout, port tensor) for every leaf."""
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(p.key for p in path)
        key = torch_key(path)
        yield key, to_torch_layout(path, np.asarray(leaf)), state_dict[key]


@pytest.fixture(scope="module")
def accum():
    from cvnets_tpu.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.metrics import build_metrics as jax_metrics
    from cvnets_tpu.models import get_model
    from cvnets_tpu.optim import build_optimizer
    from cvnets_tpu_torch.engine import train_state as port
    from cvnets_tpu_torch.loss import build_loss_fn as port_loss
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.optim import build_optimizer as port_optimizer

    opts_jax, opts_torch = both_opts(ACCUM_ARGS)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (ACCUM_BATCH, 64, 64, 3)).astype(np.uint8)
    y = rng.integers(0, 13, (ACCUM_BATCH,))

    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x.astype(np.float32) / 255.0)
    tx = build_optimizer(opts_jax)
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0),
                               {"samples": jnp.zeros((1, 64, 64, 3))})
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    state = state.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
    jstep = jax.jit(make_train_step(jmodel, build_loss_fn(opts_jax), tx, opts_jax,
                                    jax_metrics(opts_jax, ["loss", "grad_norm"])))
    state, jmetrics = jstep(state, {"samples": jnp.asarray(x), "targets": jnp.asarray(y)},
                            LR, jax.random.PRNGKey(0))
    adam = [s for s in jax.tree_util.tree_leaves(state.opt_state,
                                                 is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")]
    assert len(adam) == 1
    jgrads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / (1.0 - 0.9), adam[0].mu)

    model = port_model_from(opts_torch, variables)
    criteria = port_loss(opts_torch)
    # each micro-batch alone from the pre-step state: its grads, and what it
    # does to the BN statistics; and two forwards in a row
    halves = (slice(0, ACCUM_BATCH // 2), slice(ACCUM_BATCH // 2, ACCUM_BATCH))
    alone = []
    for half in halves:
        copy_ = copy.deepcopy(model).train()
        loss = criteria(None, copy_(nchw(x[half]).float() / 255.0), torch.from_numpy(y[half]))
        loss.backward()
        alone.append((copy_, loss.item()))
    both = copy.deepcopy(model).train()
    with torch.no_grad():
        for half in halves:
            both(nchw(x[half]).float() / 255.0)
    tstate = port.create_train_state(model, port_optimizer(opts_torch, model))
    tstep = port.make_train_step(model, criteria, opts_torch,
                                 build_metrics(opts_torch, ["loss", "grad_norm"]))
    tstate, tmetrics = tstep(tstate, {"samples": nchw(x), "targets": torch.from_numpy(y)}, LR)
    mean_grads = {name: (p.grad + dict(alone[1][0].named_parameters())[name].grad) / 2
                  for name, p in alone[0][0].named_parameters()}
    return {"jax": state, "jax_metrics": jmetrics, "jax_grads": jgrads, "model": model,
            "metrics": tmetrics, "mean_grads": mean_grads, "alone": alone[1][0].state_dict(),
            "both": both.state_dict(), "first_loss": alone[0][1], "last_loss": alone[1][1]}


def test_accumulated_grads_are_the_mean_over_micro_batches_as_jax(accum):
    """Both steps clip the mean to norm 10 (the pre-clip norm is ~17.6); the
    port's own (g1 + g2) / 2, clipped, to float32 rounding."""
    norm = accum["metrics"]["grad_norm"]["grad_norm"][0].item()
    assert norm == pytest.approx(float(accum["jax_metrics"]["grad_norm"]["grad_norm"][0]),
                                 rel=5e-4)
    scale = min(1.0, 10.0 / (norm + 1e-6))
    named = dict(accum["model"].named_parameters())
    for key, want in accum["mean_grads"].items():
        torch.testing.assert_close(named[key].grad, want * scale, rtol=1e-5, atol=1e-8,
                                   msg=key)
    # against JAX, the frameworks' float32 noise through batch-statistic BN: the
    # mean of the two micro-batches' plain grads differs by up to 3.7e-3 of the
    # largest grad at these inputs (measured), where a sum, or one grad over
    # the whole batch, would differ by far more
    gmax = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(accum["jax_grads"]))
    for key, want, _ in _pairs(accum["jax_grads"], accum["model"].state_dict()):
        np.testing.assert_allclose(named[key].grad.numpy(), want, rtol=0,
                                   atol=1e-2 * gmax, err_msg=key)


def test_accumulated_step_params_after_adamw_match_jax(accum):
    diffs = np.concatenate([np.abs(got.numpy() - want).ravel() for _, want, got in
                            _pairs(accum["jax"].params, accum["model"].state_dict())])
    # Adam's first step is ±lr an element: 1% of lr except where a noise-sized
    # grad flipped its sign, never more than the 2·lr of a flip
    assert diffs.max() <= 2.0001 * LR
    assert np.mean(diffs > 1e-2 * LR) < 0.01


def test_accumulated_step_keeps_the_bn_statistics_of_the_last_micro_batch(accum):
    sd = accum["model"].state_dict()
    moved = 0
    for key, want, got in _pairs(accum["jax"].batch_stats, sd):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-4 * np.abs(want).max(), err_msg=key)
        torch.testing.assert_close(got, accum["alone"][key], rtol=0, atol=0, msg=key)
        moved += not torch.equal(got, accum["both"][key])
    assert moved > 0  # two updates would have left other statistics


def test_accumulated_step_reports_the_loss_of_the_last_micro_batch(accum):
    loss, count = accum["metrics"]["loss"]["loss"]
    jloss, jcount = accum["jax_metrics"]["loss"]["loss"]
    assert count == float(jcount) == 1.0
    # the frameworks' float32 noise: measured 1.0e-5
    assert loss.item() == pytest.approx(float(jloss), abs=5e-5)
    assert loss.item() == pytest.approx(accum["last_loss"], rel=1e-6)
    assert abs(accum["first_loss"] - float(jloss)) > 1e-3


def test_annealed_bn_momentum_matches_the_jax_reblend():
    """JAX's test_dynamic_bn_momentum_reblend on both packages: one step of a
    BN-only model at an annealed momentum (JAX: 0.97 in the flax convention,
    the port: 0.03 in torch's), with the JAX package's ``TorchBatchNorm``,
    which tracks torch's unbiased running variance."""
    import argparse

    import flax.linen as fnn
    import optax

    from cvnets_tpu.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu.layers.normalization import TorchBatchNorm
    from cvnets_tpu_torch.engine import train_state as port

    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x, training=False):
            x = TorchBatchNorm(use_running_average=not training, momentum=0.9,
                               epsilon=1e-5)(x)
            return x.mean(axis=(1, 2, 3))

    opts = argparse.Namespace()
    setattr(opts, "model.normalization.adjust_bn_momentum.enable", True)
    setattr(opts, "model.normalization.momentum", 0.1)
    x = np.random.default_rng(0).standard_normal((4, 8, 8, 3)).astype(np.float32)

    def criteria(samples, prediction, targets, training=False, **kwargs):
        return (prediction ** 2).mean()

    model = M()
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.0)
    batch = {"samples": jnp.asarray(x), "targets": jnp.zeros((4,))}
    state = create_train_state(model, tx, jax.random.PRNGKey(0), batch)
    state, _ = jax.jit(make_train_step(model, criteria, tx, opts, {}))(
        state, batch, 0.0, jax.random.PRNGKey(0), 0, 0.97)
    want, = state.batch_stats.values()

    bn = torch.nn.Sequential(torch.nn.BatchNorm2d(3, momentum=0.1, eps=1e-5))
    tstate = port.TrainState(model=bn, optimizer=torch.optim.SGD(bn.parameters(), lr=0.0))
    tstep = port.make_train_step(bn, criteria, opts, {})
    tstep(tstate, {"samples": nchw(x), "targets": torch.zeros(4)}, 0.0, bn_momentum=0.03)
    # 1e-5 relative: float32 re-blend arithmetic
    np.testing.assert_allclose(bn[0].running_mean.numpy(), np.asarray(want["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn[0].running_var.numpy(), np.asarray(want["var"]),
                               rtol=1e-5, atol=1e-7)
    assert bn[0].momentum == 0.03


# the port's Trainer against the JAX Trainer: SGD, so that float32 noise in the
# grads moves the params by lr times that noise (Adam would turn it into ±lr)
TRAINER_ARGS = SMALL_MODEL_ARGS + [
    "--sampler.bs.crop-size-width", "64",
    "--sampler.bs.crop-size-height", "64",
    "--optim.name", "sgd",
    "--optim.sgd.momentum", "0.9",
    "--optim.weight-decay", "1e-4",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "2",
    "--scheduler.warmup-iterations", "2",
    "--scheduler.warmup-init-lr", "0.001",
    "--scheduler.cosine.max-lr", "0.005",
    "--scheduler.cosine.min-lr", "0.0005",
    "--ema.enable",
    "--ema.momentum", "0.2",
    "--stats.train", "loss", "grad_norm",
    "--stats.val", "loss", "top1", "top5",
    "--stats.checkpoint-metric", "top1",
    "--stats.checkpoint-metric-max",
    "--common.log-freq", "1",
    "--common.k-best-checkpoints", "2",
]
N_TRAIN, N_VAL, TRAINER_BATCH = 2, 2, 8


def _record(trainer):
    """Wrap the trainer's epochs so that their statistics are kept."""
    out = {"train": [], "val": [], "ema": []}
    train_epoch, val_epoch = trainer.train_epoch, trainer.val_epoch

    def train(epoch):
        out["train"].append(train_epoch(epoch))
        return out["train"][-1]

    def val(epoch, use_ema=False):
        out["ema" if use_ema else "val"].append(val_epoch(epoch, use_ema=use_ema))
        return out["ema" if use_ema else "val"][-1]

    trainer.train_epoch, trainer.val_epoch = train, val
    return out


def test_trainer_matches_the_jax_trainer_over_two_epochs(tmp_path):
    from cvnets_tpu.engine import Trainer as JaxTrainer
    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.models import get_model
    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.loss import build_loss_fn as port_loss

    opts_jax, _ = both_opts(TRAINER_ARGS + ["--common.results-loc", str(tmp_path / "jax")])
    _, opts_torch = both_opts(TRAINER_ARGS + ["--common.results-loc", str(tmp_path / "port")])
    rng = np.random.default_rng(0)

    def batches(n):
        return [(rng.integers(0, 256, (TRAINER_BATCH, 64, 64, 3)).astype(np.uint8),
                 rng.integers(0, 13, (TRAINER_BATCH,))) for _ in range(n)]

    train, val = batches(N_TRAIN), batches(N_VAL)
    jmodel = get_model(opts_jax)
    jtrainer = JaxTrainer(opts_jax, jmodel, build_loss_fn(opts_jax),
                          [{"samples": x, "targets": y} for x, y in train],
                          [{"samples": x, "targets": y} for x, y in val])
    variables = jax.device_get({"params": jtrainer.state.params,
                                "batch_stats": jtrainer.state.batch_stats})
    model = port_model_from(opts_torch, variables)
    trainer = Trainer(opts_torch, model, port_loss(opts_torch),
                      [{"samples": nchw(x), "targets": torch.from_numpy(y)} for x, y in train],
                      [{"samples": nchw(x), "targets": torch.from_numpy(y)} for x, y in val],
                      device="cpu")
    want, got = _record(jtrainer), _record(trainer)
    jtrainer.run()
    trainer.run()
    assert trainer.train_iterations == jtrainer.train_iterations == 4
    share = 100.0 / (N_VAL * TRAINER_BATCH)  # one sample's share of top-k
    # The first step starts from one state, so epoch 0 agrees to float32 noise
    # (measured 3e-6 in the loss, 6e-7 relative in the grad norm); through
    # batch-statistic BN at 8 images that noise grows by the last step to
    # 5.5e-4 in the train loss, 0.5% in the grad norm and 4.5e-4 in the val
    # loss (measured with tests/conftest.py's XLA flags). An EMA val run on
    # the live model, or a sum where a mean belongs, is off by 2e-2 or more.
    bounds = ({"loss": 1e-3, "grad_norm": 1e-2}, {"loss": 5e-3, "grad_norm": 5e-2})
    for epoch in range(2):
        w, g = want["train"][epoch], got["train"][epoch]
        assert list(g) == list(w) == ["loss", "grad_norm"]
        assert g["loss"] == pytest.approx(w["loss"], abs=bounds[epoch]["loss"]), epoch
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=bounds[epoch]["grad_norm"])
        for stage in ("val", "ema"):
            w, g = want[stage][epoch], got[stage][epoch]
            assert list(g) == list(w) == ["loss", "top1", "top5"]
            assert g["loss"] == pytest.approx(w["loss"], abs=5e-3), (stage, epoch)
            for k in ("top1", "top5"):
                assert abs(g[k] - w[k]) <= share + 1e-9, (stage, epoch, k)
    assert trainer.ckpt_manager.best_metric == pytest.approx(
        jtrainer.ckpt_manager.best_metric, abs=share + 1e-9)


def _micro_trainer(tmp_path, extra=(), n_train=4):
    from torch_port_helpers import TRAINER_MICRO_ARGS, uint8_batches

    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=TRAINER_MICRO_ARGS + [
        "--common.results-loc", str(tmp_path)] + list(extra))
    return Trainer(opts, get_model(opts, device="cpu"), build_loss_fn(opts),
                   uint8_batches(1, n_train), uint8_batches(2, 2), device="cpu")


def test_epochs_before_accum_after_epoch_take_the_step_without_accumulation(tmp_path):
    trainer = _micro_trainer(tmp_path, ["--common.accum-freq", "2",
                                        "--common.accum-after-epoch", "1",
                                        "--scheduler.max-epochs", "2"], n_train=2)
    rows = []  # the batch size of every train-mode forward
    trainer.model.register_forward_pre_hook(
        lambda m, args: rows.append(args[0].shape[0]) if m.training else None)
    trainer.run()
    assert rows == [4, 4] + [2, 2, 2, 2]


def test_trainer_reads_back_only_at_log_points_and_the_end_of_an_epoch(tmp_path):
    """Five batches an epoch at log-freq 2: read-backs after iterations 2, 4 and
    5, then 6, 8 and 10; the epoch's loss is the mean over its batches."""
    trainer = _micro_trainer(tmp_path, ["--common.log-freq", "2", "--scheduler.max-epochs",
                                        "2", "--stats.train", "loss", "grad_norm"], n_train=5)
    read_at, losses, epochs = [], [], []
    read_back, step, train_epoch = trainer.read_back, trainer._train_step, trainer.train_epoch

    def recording_read_back(*args):
        read_at.append(trainer.train_iterations)
        return read_back(*args)

    def recording_step(*args):
        state, pairs = step(*args)
        losses.append(pairs["loss"]["loss"][0].item())
        return state, pairs

    trainer.read_back, trainer._train_step = recording_read_back, recording_step
    trainer.train_epoch = lambda epoch: epochs.append(train_epoch(epoch)) or epochs[-1]
    trainer.run()
    assert read_at == [2, 4, 5, 6, 8, 10]
    for i, stats in enumerate(epochs):
        assert set(stats) == {"loss", "grad_norm"}
        assert stats["loss"] == pytest.approx(np.mean(losses[5 * i:5 * i + 5]), rel=1e-6)


def test_ema_copy_at_epoch_puts_the_ema_weights_into_the_model(tmp_path):
    """The same epoch with and without ``--ema.copy-at-epoch 0``: the copy's
    model (and its checkpoint_last.pt) is the other run's EMA model."""
    runs = []
    for extra in ([], ["--ema.copy-at-epoch", "0"]):
        trainer = _micro_trainer(tmp_path / str(len(runs)), extra + [
            "--scheduler.max-epochs", "1"], n_train=2)
        trainer.run()
        runs.append(trainer)
    plain, copied = runs
    ema = plain.state.ema.model.state_dict()
    last = torch.load(f"{copied.save_dir}/checkpoint_last.pt", weights_only=True)
    for key, value in copied.model.state_dict().items():
        assert torch.equal(value, ema[key]) and torch.equal(last[key], ema[key]), key
    assert not all(torch.equal(v, ema[k]) for k, v in plain.model.state_dict().items())


@pytest.mark.parametrize("flag", [
    "--common.profile-trace-dir=trace",
])
def test_trainer_refuses_what_is_not_ported_and_names_its_roadmap_item(flag):
    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=[flag])
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1 item 1\)"):
        Trainer(opts, None, None, [], device="cpu")


@pytest.mark.parametrize("flag", [
    "--image-augmentation.rand-augment.enable",
    "--image-augmentation.trivial-augment-wide.enable",
    "--image-augmentation.random-erase.enable",
    "--image-augmentation.mixup.enable",
    "--image-augmentation.cutmix.enable",
])
def test_trainer_trains_with_each_augmentation_switch(flag, tmp_path):
    """The switches the Trainer refused until the device-tier augmentation was
    ported: an epoch runs with each, on augmented (and for mixup and cutmix,
    soft) targets, and gives other weights than the same epoch without it."""
    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    def one_epoch(extra):
        opts = get_training_arguments(args=SMALL_MODEL_ARGS + [
            "--optim.name", "adamw", "--scheduler.max-epochs", "1",
            "--common.results-loc", str(tmp_path / str(len(extra)))] + extra)
        targets = []
        criteria = build_loss_fn(opts)

        def loss(x, prediction, target, **kwargs):
            targets.append(target)
            return criteria(x, prediction, target, **kwargs)

        trainer = Trainer(opts, get_model(opts, device="cpu"), loss, uint8_batches(3, 1),
                          device="cpu")
        trainer.run()
        return trainer.model.state_dict(), targets[0]

    with torch_threads(2):
        with_it, targets = one_epoch([flag])
        without, _ = one_epoch([])
    assert targets.dim() == (2 if "mixup" in flag or "cutmix" in flag else 1)
    assert not all(torch.equal(v, without[k]) for k, v in with_it.items())
