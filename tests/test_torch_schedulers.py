"""The port's LR schedulers against the JAX package's (cvnets_tpu/optim/scheduler.py):
``fixed``, ``polynomial``, ``multi_step``, ``cyclic`` and ``cosine``, each
with the shared warmup, give the JAX ``retrieve_lr`` bit for bit (both round
to 8 places) at every iteration of a short run, called in the Trainer's order
(the epoch-based schedules remember the last warmup epoch). ``fixed`` without
a LR fails in both; an unknown name lists every registered scheduler."""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port_helpers import both_opts  # noqa: E402

EPOCHS, ITERS_AN_EPOCH = 6, 7

CASES = {
    "fixed": ["--scheduler.name", "fixed", "--scheduler.fixed.lr", "1e-3",
              "--scheduler.warmup-iterations", "9", "--scheduler.warmup-init-lr", "1e-6"],
    "fixed_no_warmup": ["--scheduler.name", "fixed", "--scheduler.fixed.lr", "0.37"],
    "multi_step": ["--scheduler.name", "multi_step", "--scheduler.multi-step.lr", "0.02",
                   "--scheduler.multi-step.gamma", "0.1",
                   "--scheduler.multi-step.milestones", "4", "2",
                   "--scheduler.warmup-iterations", "5", "--scheduler.warmup-init-lr", "1e-4"],
    "polynomial_iterations": ["--scheduler.name", "polynomial", "--scheduler.is-iteration-based",
                              "--scheduler.max-iterations", "40",
                              "--scheduler.polynomial.power", "0.9",
                              "--scheduler.polynomial.start-lr", "0.01",
                              "--scheduler.polynomial.end-lr", "1e-4",
                              "--scheduler.warmup-iterations", "3"],
    "polynomial_epochs_adjusted": ["--scheduler.name", "polynomial", "--scheduler.max-epochs",
                                   "6", "--scheduler.adjust-period-for-epochs",
                                   "--scheduler.warmup-iterations", "10",
                                   "--scheduler.polynomial.start-lr", "0.05"],
    "cyclic": ["--scheduler.name", "cyclic", "--scheduler.cyclic.min-lr", "0.01",
               "--scheduler.cyclic.max-lr", "0.2", "--scheduler.cyclic.steps-per-cycle", "6",
               "--scheduler.cyclic.epochs-per-cycle", "3", "--scheduler.warmup-iterations", "4"],
    "cosine_epochs_adjusted": ["--scheduler.name", "cosine", "--scheduler.max-epochs", "6",
                               "--scheduler.adjust-period-for-epochs",
                               "--scheduler.warmup-iterations", "8",
                               "--scheduler.cosine.max-lr", "0.1",
                               "--scheduler.cosine.min-lr", "1e-3"],
}


def _lrs(scheduler) -> list:
    return [scheduler.retrieve_lr(epoch, epoch * ITERS_AN_EPOCH + i)
            for epoch in range(EPOCHS) for i in range(ITERS_AN_EPOCH)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_iterations_lr_is_the_jax_schedulers(case):
    from cvnets_tpu.optim.scheduler import build_scheduler as jax_build
    from cvnets_tpu_torch.optim.scheduler import build_scheduler

    opts_jax, opts_torch = both_opts(CASES[case])
    got, want = _lrs(build_scheduler(opts_torch)), _lrs(jax_build(opts_jax))
    assert got == want  # exact: the same float64 formulas, rounded to 8 places
    assert len(set(got)) > 1 or case == "fixed_no_warmup"


@pytest.mark.parametrize("name,lr", [("fixed", 1e-3), ("multi_step", 0.02),
                                     ("polynomial", 0.05), ("cyclic", 0.2)])
def test_warmup_is_linear_from_warmup_init_lr_to_the_schedules_peak(name, lr):
    from cvnets_tpu_torch.optim.scheduler import build_scheduler

    flag = {"fixed": "fixed.lr", "multi_step": "multi-step.lr",
            "polynomial": "polynomial.start-lr", "cyclic": "cyclic.max-lr"}[name]
    _, opts = both_opts(["--scheduler.name", name, f"--scheduler.{flag}", str(lr),
                         "--scheduler.warmup-iterations", "10",
                         "--scheduler.warmup-init-lr", "1e-6",
                         "--scheduler.is-iteration-based", "--scheduler.max-iterations", "100"])
    scheduler = build_scheduler(opts)
    assert scheduler.retrieve_lr(0, 0) == 1e-6
    for i in range(10):
        assert scheduler.retrieve_lr(0, i) == round(1e-6 + i * (lr - 1e-6) / 10, 8)
    # after the warmup: the LR itself, but a cycle, which restarts at its min-lr
    assert scheduler.retrieve_lr(0, 10) == pytest.approx(0.1 if name == "cyclic" else lr,
                                                         rel=1e-7)


def test_fixed_without_a_lr_fails_as_in_jax():
    from cvnets_tpu.optim.scheduler import build_scheduler as jax_build
    from cvnets_tpu_torch.optim.scheduler import build_scheduler

    opts_jax, opts_torch = both_opts(["--scheduler.name", "fixed"])
    for build, opts in ((jax_build, opts_jax), (build_scheduler, opts_torch)):
        with pytest.raises(SystemExit, match="scheduler.fixed.lr must be set"):
            build(opts)


def test_an_unknown_scheduler_lists_every_registered_one():
    from cvnets_tpu_torch.optim.scheduler import build_scheduler

    _, opts = both_opts(["--scheduler.name", "step"])
    with pytest.raises(SystemExit) as err:
        build_scheduler(opts)
    for name in ("fixed", "cosine", "polynomial", "multi_step", "cyclic"):
        assert f"'{name}'" in str(err.value)


# config/classification/finetune_higher_res_in1k/mobilevit_v2.yaml (the fixed
# scheduler's yaml: MobileViTv2-2.0 at 384², SGD, fixed LR 1e-3 after a warmup
# from 1e-6, --common.finetune from a 256² checkpoint) at a CPU test's scale:
# width 0.5, the port's dummy dataset at 64 px, batch 2, one epoch, a warmup
# of 5 iterations
FINETUNE_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "config/classification/finetune_higher_res_in1k/mobilevit_v2.yaml")
FINETUNE_OVERRIDES = [
    "dataset.name=dummy_classification", "dataset.workers=2",
    "dataset.train_batch_size0=2", "dataset.val_batch_size0=2",
    "model.classification.n_classes=10", "model.classification.mitv2.width_multiplier=0.5",
    "sampler.bs.crop_size_width=64", "sampler.bs.crop_size_height=64",
    "image_augmentation.resize.size=64", "image_augmentation.center_crop.size=64",
    "scheduler.max_epochs=1", "scheduler.warmup_iterations=5",
]


@pytest.mark.parametrize("scheduler", ["fixed", "multi_step"])
def test_finetune_yaml_trains_from_its_checkpoint_at_the_schedulers_lr(scheduler, tmp_path,
                                                                        monkeypatch):
    """main_train on the finetune yaml: the model and its EMA start from the
    checkpoint given to --common.finetune, and the LR the train step writes
    into the optimizer at every iteration is the scheduler's host value (the
    yaml's fixed LR, and a multi-step schedule with milestones at epochs 0 and 5)."""
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from torch_port_helpers import register_port_dummy_dataset, torch_threads

    register_port_dummy_dataset()
    extra = [] if scheduler == "fixed" else [
        "scheduler.name=multi_step", "scheduler.multi_step.lr=0.01",
        "scheduler.multi_step.milestones=0,5", "scheduler.multi_step.gamma=0.5"]
    args = ["--common.config-file", FINETUNE_YAML, "--common.override-kwargs",
            *FINETUNE_OVERRIDES, *extra, f"common.results_loc={tmp_path}"]
    opts = get_training_arguments(args=args)
    source = get_model(opts, generator=torch.Generator().manual_seed(11), device="cpu")
    ckpt = str(tmp_path / "mobilevit_v2_256.pt")
    torch.save(source.state_dict(), ckpt)
    built, lrs = [], []

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)
            self.start = {k: v.clone() for k, v in self.state.ema.model.state_dict().items()}
            step = self._train_step

            def recorded(state, batch, lr, *rest):
                out = step(state, batch, lr, *rest)
                lrs.append((lr, [g["lr"] for g in state.optimizer.param_groups]))
                return out

            self._train_step = recorded

    monkeypatch.setattr(main_train, "Trainer", Recorded)
    with torch_threads(2):
        main_train.main_worker(args=args + [f"common.finetune={ckpt}"], device="cpu")
    trainer = built[0]
    for key, value in source.state_dict().items():
        assert torch.equal(trainer.start[key], value), key
    want = [trainer.scheduler.retrieve_lr(0, i) for i in range(len(lrs))]
    assert [lr for lr, _ in lrs] == want and len(lrs) == 8  # 16 samples / 2
    assert all(groups == [lr] * len(groups) for lr, groups in lrs)
    peak = 1e-3 if scheduler == "fixed" else 0.005
    assert want[0] == 1e-6 and want[-1] == peak



def test_chip_smoke_finetune_flags_are_the_yaml_settings():
    """chip_smoke.py's MobileViTv2-2.0 384² finetune phase sets the yaml's
    value of every model, loss, optimizer, schedule, EMA, batch and crop
    setting, and nothing the yaml leaves at its default."""
    from chip_smoke import FINETUNE_ARGS
    from cvnets_tpu_torch.options.opts import get_training_arguments

    default = vars(get_training_arguments(args=[]))
    flags = vars(get_training_arguments(args=FINETUNE_ARGS))
    yaml = vars(get_training_arguments(args=["--common.config-file", FINETUNE_YAML]))
    kept = ("model.", "loss.", "optim.", "scheduler.", "ema.", "common.mixed_precision",
            "dataset.train_batch_size0", "sampler.")
    for dest, value in yaml.items():
        if dest.startswith(kept) and value != default[dest]:
            assert flags[dest] == value, dest
    for dest, value in flags.items():
        if value != default[dest]:
            assert yaml[dest] == value, dest
