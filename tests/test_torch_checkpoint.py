"""The port's checkpoints (``cvnets_tpu_torch/utils/checkpoint_utils.py``) on
micro MobileViTv2 Trainer runs on the CPU: every file role of the JAX package,
``checkpoint_avg`` as the float64 mean of the kept files, a run stopped after
two epochs and resumed that ends bit for bit where an unbroken run ends, the
k-best list a resume does not restore (as in the JAX package), the Evaluator on
a checkpoint, and ``checkpoint_last.pt`` carried back to the JAX params it was
loaded from by the JAX package's ``convert_torch_checkpoint``
(cvnets_tpu/utils/torch_checkpoint_converter.py:114)."""

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
    SMALL_MODEL_ARGS,
    TRAINER_MICRO_ARGS,
    both_opts,
    port_model_from,
    uint8_batches,
)

RUN_ARGS = ["--common.log-freq", "2", "--common.save-interval-freq", "3",
            "--common.k-best-checkpoints", "2", "--common.save-all-checkpoints",
            "--common.auto-resume"]


def _trainer(results, extra=()):
    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=TRAINER_MICRO_ARGS + RUN_ARGS + [
        "--common.results-loc", str(results)] + list(extra))
    return Trainer(opts, get_model(opts, device="cpu"), build_loss_fn(opts),
                   uint8_batches(1, 4), uint8_batches(2, 2), device="cpu")


def _recording(trainer):
    """Keep the statistics of each validation epoch, EMA's apart."""
    out = {"val": [], "ema": []}
    val_epoch = trainer.val_epoch

    def val(epoch, use_ema=False):
        out["ema" if use_ema else "val"].append(val_epoch(epoch, use_ema=use_ema))
        return out["ema" if use_ema else "val"][-1]

    trainer.val_epoch = val
    return out


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def three_epochs(tmp_path_factory):
    results = tmp_path_factory.mktemp("run")
    trainer = _trainer(results)
    stats = _recording(trainer)
    trainer.run()
    return trainer, stats


def test_every_checkpoint_role_after_three_epochs(three_epochs):
    trainer, _ = three_epochs
    scores = [os.path.basename(p) for _, p in trainer.ckpt_manager.k_best_scores]
    assert len(scores) == 2
    want = {"config.yaml", "training_checkpoint_last.pt", "checkpoint_last.pt",
            "checkpoint_best.pt", "checkpoint_ema_last.pt", "checkpoint_ema_best.pt",
            "checkpoint_avg.pt", *scores, *(f"checkpoint_epoch_{e}.pt" for e in range(3)),
            *(f"checkpoint_iter_{n}.pt" for n in (3, 6, 9, 12))}
    assert set(os.listdir(trainer.save_dir)) == want
    d = trainer.save_dir
    last, ema_last = _load(f"{d}/checkpoint_last.pt"), _load(f"{d}/checkpoint_ema_last.pt")
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(last[key], value), key
        assert torch.equal(_load(f"{d}/checkpoint_epoch_2.pt")[key], value), key
    for key, value in trainer.state.ema.model.state_dict().items():
        assert torch.equal(ema_last[key], value), key
    blob = _load(f"{d}/training_checkpoint_last.pt")
    assert (blob["epoch"], blob["iterations"]) == (2, 12)
    assert blob["best_metric"] == trainer.ckpt_manager.best_metric
    assert set(blob) == {"epoch", "iterations", "best_metric", "model", "optimizer", "ema",
                         "generator", "rng"}
    with open(f"{d}/config.yaml") as f:  # JSON, which YAML reads
        import json

        assert json.load(f)["stats.checkpoint_metric"] == "top1"


def test_checkpoint_avg_is_the_float64_mean_of_the_kept_files(three_epochs):
    trainer, _ = three_epochs
    kept = [_load(p) for _, p in trainer.ckpt_manager.k_best_scores]
    avg = _load(os.path.join(trainer.save_dir, "checkpoint_avg.pt"))
    params = dict(trainer.model.named_parameters())
    for key, value in trainer.model.state_dict().items():
        if key in params:
            want = (sum(sd[key].double() for sd in kept) / len(kept)).float()
            assert torch.equal(avg[key], want), key
        else:  # buffers: the current model's, as the JAX package's batch_stats
            assert torch.equal(avg[key], value), key
    assert not all(torch.equal(avg[k], trainer.model.state_dict()[k]) for k in params)


def test_a_run_stopped_after_two_epochs_resumes_bit_identical(tmp_path, three_epochs):
    """2 + 1 epochs against the unbroken 3, with accumulation after epoch 1 and
    an annealed BN momentum so that the resumed step takes both."""
    extra = ["--common.accum-freq", "2", "--common.accum-after-epoch", "1",
             "--model.normalization.adjust-bn-momentum.enable"]
    whole = _trainer(tmp_path / "whole", extra)
    whole_stats = _recording(whole)
    whole.run()
    first = _trainer(tmp_path / "broken", extra)
    first.max_epochs = 2  # as if the run had been stopped after epoch 1's checkpoints
    first.run()
    resumed = _trainer(tmp_path / "broken", extra)
    assert (resumed.start_epoch, resumed.train_iterations) == (2, 8)
    assert resumed.ckpt_manager.k_best_scores == []  # not restored, as in the JAX package
    assert resumed.ckpt_manager.best_metric == first.ckpt_manager.best_metric
    resumed_stats = _recording(resumed)
    resumed.run()
    for a, b in ((whole.model, resumed.model), (whole.state.ema.model, resumed.state.ema.model)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), key
    opt_a, opt_b = whole.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i, st in opt_a["state"].items():
        for key in st:
            assert torch.equal(st[key], opt_b["state"][i][key]), (i, key)
    assert whole.state.step == resumed.state.step == whole.train_iterations == 12
    assert whole_stats["val"][-1] == resumed_stats["val"][-1]
    assert whole_stats["ema"][-1] == resumed_stats["ema"][-1]
    assert torch.equal(whole.generator.get_state(), resumed.generator.get_state())


def test_resume_from_an_explicit_path_restores_every_part(three_epochs, tmp_path):
    trainer, _ = three_epochs
    path = os.path.join(trainer.save_dir, "training_checkpoint_last.pt")
    other = _trainer(tmp_path, ["--common.resume", path])
    assert (other.start_epoch, other.train_iterations, other.state.step) == (3, 12, 12)
    assert other.ckpt_manager.best_metric == trainer.ckpt_manager.best_metric
    for a, b in ((trainer.model, other.model), (trainer.state.ema.model, other.state.ema.model)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), key
    for i, st in trainer.state.optimizer.state_dict()["state"].items():
        got = other.state.optimizer.state_dict()["state"][i]
        assert all(torch.equal(st[k], got[k]) for k in st), i
        assert got["step"].device.type == "cpu"  # where a non-capturable AdamW keeps it


def test_evaluator_on_the_ema_checkpoint_gives_the_last_ema_validation(three_epochs):
    from cvnets_tpu_torch.engine import Evaluator
    from cvnets_tpu_torch.models import get_model

    trainer, stats = three_epochs
    evaluator = Evaluator(trainer.opts, get_model(trainer.opts, device="cpu"),
                          uint8_batches(2, 2),
                          checkpoint=os.path.join(trainer.save_dir, "checkpoint_ema_last.pt"),
                          device="cpu")
    assert evaluator.eval_fn_image() == stats["ema"][-1]


def test_checkpoint_last_converts_back_to_the_jax_params(tmp_path):
    """The JAX package's converter walks a reference-cvnets state dict in
    definition order; the port's ``checkpoint_last.pt`` of a model filled from
    JAX variables gives those variables back exactly."""
    from cvnets_tpu.engine.train_state import jit_init_ordered
    from cvnets_tpu.models import get_model
    from cvnets_tpu.utils.torch_checkpoint_converter import convert_torch_checkpoint
    from cvnets_tpu_torch.engine.train_state import create_train_state
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.utils.checkpoint_utils import CheckpointManager

    opts_jax, opts_torch = both_opts(SMALL_MODEL_ARGS + [
        "--common.results-loc", str(tmp_path), "--common.k-best-checkpoints", "0"])
    jmodel, key = get_model(opts_jax), jax.random.PRNGKey(0)
    # the converter needs the leaves in definition order, which jit would sort
    variables = jit_init_ordered(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 64, 64, 3)), training=False))
    rng = np.random.default_rng(0)

    def perturb(tree):  # off the init values (unit scales, (0, 1) BN stats), in order
        return {k: perturb(v) if isinstance(v, dict) else
                np.asarray(v) + 0.05 * rng.standard_normal(np.shape(v)).astype(np.float32)
                for k, v in tree.items()}

    variables = {col: perturb(tree) for col, tree in variables.items()}
    model = port_model_from(opts_torch, variables)
    manager = CheckpointManager(opts_torch, str(tmp_path))
    manager.save(create_train_state(model, build_optimizer(opts_torch, model)), 0, 0, 1.0)
    state_dict = {k: v.numpy() for k, v in _load(manager.path("checkpoint_last")).items()}
    params, batch_stats, unmatched = convert_torch_checkpoint(
        state_dict, variables["params"], variables["batch_stats"])
    assert not unmatched, unmatched[:5]
    for tree, want in ((params, variables["params"]), (batch_stats, variables["batch_stats"])):
        got_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, got), (_, leaf) in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf), err_msg=str(path))
