"""Distillation in the PyTorch port against the JAX package, on the CPU at
micro sizes: ``soft_kl_loss`` (T 1 and 2) and ``hard_distillation`` with a
ResNet-18 teacher whose JAX ``teacher_variables`` (perturbed off their init)
are loaded into the port's, the teacher built from the ``--teacher.model.*``
clones, its ``pretrained`` checkpoint, and the two distillation yamls
(``loss.category: distillation``, and RangeAugment's composite of soft KL and
neural augmentation) through ``main_train`` for one epoch, the teacher outside
the checkpoint, the EMA and the optimizer. Tolerances: the losses 1e-5
relative (a float32 teacher forward through 18 layers on both sides)."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import (  # noqa: E402
    both_opts,
    nchw,
    register_port_dummy_dataset,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

TEACHER_ARGS = [
    "--dataset.category", "classification",
    "--model.classification.name", "mobilenetv1",
    "--model.classification.n-classes", "10",
    "--teacher.model.classification.name", "resnet",
    "--teacher.model.classification.resnet.depth", "18",
    "--teacher.model.classification.n-classes", "10",
    "--teacher.model.activation.name", "relu",
    "--teacher.model.layer.conv-init", "kaiming_normal",
    "--teacher.model.layer.linear-init", "normal",
]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _perturbed(variables: dict, seed: int = 0) -> dict:
    """numpy teacher variables moved off their init (biases, scales, BN stats)."""
    import jax

    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf, name = np.asarray(leaf), path[-1].key
        if name == "var":
            return leaf * (1.0 + 0.1 * rng.random(leaf.shape, dtype=np.float32))
        if name in ("mean", "bias", "scale"):
            return leaf + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return leaf

    return {col: jax.tree_util.tree_map_with_path(perturb, tree)
            for col, tree in variables.items()}


@pytest.fixture(scope="module")
def pairs():
    """{(name, T): (JAX loss, port loss)} on one perturbed teacher."""
    from cvnets_tpu.loss import build_loss_fn as jax_build
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.utils.jax_params import load_jax_teacher

    out, variables = {}, None
    for name, t in (("soft_kl_loss", 1.0), ("soft_kl_loss", 2.0), ("hard_distillation", 1.0)):
        opts_jax, opts_torch = both_opts(TEACHER_ARGS + [
            "--loss.category", "distillation", "--loss.distillation.name", name,
            "--loss.distillation.soft-kl-loss.temperature", str(t)])
        jcrit = jax_build(opts_jax)
        if variables is None:
            variables = _perturbed(jcrit.teacher_variables)
        jcrit.teacher_variables = variables
        crit = build_loss_fn(opts_torch, device="cpu")
        load_jax_teacher(crit, variables)
        out[name, t] = (jcrit, crit)
    return out


@pytest.mark.parametrize("name,t", [("soft_kl_loss", 1.0), ("soft_kl_loss", 2.0),
                                    ("hard_distillation", 1.0)])
def test_distillation_loss_matches_jax_on_the_same_teacher(pairs, name, t):
    import jax.numpy as jnp

    jcrit, crit = pairs[name, t]
    rng = np.random.default_rng(4)
    x = rng.random((4, 32, 32, 3), dtype=np.float32)
    student = 2 * rng.standard_normal((4, 10)).astype(np.float32)
    want = float(jcrit(jnp.asarray(x), {"logits": jnp.asarray(student)}, None, training=True))
    logits = torch.from_numpy(student).requires_grad_(True)
    got = crit(nchw(x), {"logits": logits}, None, training=True)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    np.testing.assert_allclose(crit(nchw(x), logits, None).item(), want, rtol=1e-5)
    # the teacher's logits agree, and only the student gets a gradient
    np.testing.assert_allclose(crit.teacher_logits(nchw(x)).numpy(),
                               np.asarray(jcrit._teacher_logits(jnp.asarray(x))),
                               rtol=0, atol=1e-4)
    got.backward()
    assert logits.grad is not None and float(logits.grad.abs().sum()) > 0
    assert not crit.teacher.training
    assert all(not p.requires_grad and p.grad is None for p in crit.teacher.parameters())
    if name == "soft_kl_loss":
        assert crit.temperature == t


def test_the_teacher_is_the_teacher_options_model_on_the_runs_device():
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models.classification.resnet import ResNet

    _, opts = both_opts(TEACHER_ARGS + ["--loss.category", "distillation"])
    crit = build_loss_fn(opts, device="cpu")
    assert isinstance(crit.teacher, ResNet) and crit.teacher.classifier.fc.out_features == 10
    assert "neural_augmentor" not in crit.teacher._modules
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_loss_fn(opts)  # the default device is the card


def test_a_teacher_checkpoint_of_the_port_loads_and_a_foreign_one_raises(tmp_path):
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.utils import extract_opts_with_prefix_replacement
    from cvnets_tpu_torch.utils.checkpoint_utils import UNPORTED_CHECKPOINT

    _, opts = both_opts(TEACHER_ARGS + ["--loss.category", "distillation",
                                        "--common.seed", "3"])
    teacher_opts = extract_opts_with_prefix_replacement(opts, "teacher.model.", "model.")
    source = get_model(teacher_opts, category="classification",
                       generator=torch.Generator().manual_seed(7), device="cpu")
    path = str(tmp_path / "teacher.pt")
    torch.save(source.state_dict(), path)
    setattr(opts, "teacher.model.classification.pretrained", path)
    crit = build_loss_fn(opts, device="cpu")
    for key, value in source.state_dict().items():
        assert torch.equal(crit.teacher.state_dict()[key], value), key
    foreign = str(tmp_path / "reference.pt")
    torch.save({"model_state_dict": source.state_dict()}, foreign)
    setattr(opts, "teacher.model.classification.pretrained", foreign)
    with pytest.raises(NotImplementedError, match="--teacher.model.classification.pretrained"):
        build_loss_fn(opts, device="cpu")
    with pytest.raises(NotImplementedError) as err:
        build_loss_fn(opts, device="cpu")
    assert UNPORTED_CHECKPOINT in str(err.value)


MOE_FLAG = "model.moe.aux_loss_weight"


def test_teacher_flags_clone_every_model_flag_with_the_jax_dests():
    opts_jax, opts_torch = both_opts(["--teacher.model.classification.name", "resnet",
                                      "--teacher.model.learn-augmentation.brightness"])
    model = [k for k in vars(opts_torch) if k.startswith("model.")]
    teacher = [k for k in vars(opts_torch) if k.startswith("teacher.")]
    # every --model.* flag of the model arguments; --model.moe.aux-loss-weight
    # is defined outside them in both packages and has no clone
    assert sorted(teacher) == sorted("teacher." + k for k in model if k != MOE_FLAG)
    assert not hasattr(opts_jax, "teacher." + MOE_FLAG)
    for dest in teacher:
        assert getattr(opts_jax, dest) == getattr(opts_torch, dest), dest
    # a store-true flag's clone takes an optional value
    assert getattr(opts_torch, "teacher.model.learn_augmentation.brightness") is True
    assert getattr(opts_torch, "model.learn_augmentation.brightness") is False


# ---- the distillation yamls through main_train --------------------------------
YAMLS = {
    "distillation": "config/distillation/teacher_resnet101_student_mobilenet_v1.yaml",
    "range_augment": "examples/range_augment/distillation/"
                     "teacher_resnet101_student_mobilenet_v2.yaml",
}
# both at a CPU test's scale: the students at width 0.25, a ResNet-18 teacher
# with fresh weights (no checkpoint), 10 classes, the port's dummy dataset,
# the variable batch sampler at 32-96 px around 64, base batch 4, one epoch
OVERRIDES = [
    "dataset.name=dummy_classification",
    "dataset.train_batch_size0=4", "dataset.val_batch_size0=4", "dataset.workers=2",
    "model.classification.n_classes=10", "teacher.model.classification.n_classes=10",
    "model.classification.mobilenetv1.width_multiplier=0.25",
    "model.classification.mobilenetv2.width_multiplier=0.25",
    "teacher.model.classification.resnet.depth=18",
    "teacher.model.classification.pretrained=",
    "sampler.vbs.crop_size_width=64", "sampler.vbs.crop_size_height=64",
    "sampler.vbs.min_crop_size_width=32", "sampler.vbs.max_crop_size_width=96",
    "sampler.vbs.min_crop_size_height=32", "sampler.vbs.max_crop_size_height=96",
    "sampler.vbs.max_n_scales=3", "sampler.vbs.check_scale=16",
    "image_augmentation.resize.size=72", "image_augmentation.center_crop.size=64",
    "scheduler.max_epochs=1", "scheduler.warmup_iterations=2",
]


@pytest.mark.parametrize("yaml", sorted(YAMLS))
def test_distillation_yaml_trains_an_epoch_with_the_teacher_outside_the_state(
        yaml, tmp_path, monkeypatch):
    import math

    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.utils.checkpoint_utils import load_file

    register_port_dummy_dataset()
    built, stats, before = [], [], {}

    def teacher_of(crit):
        return (crit.loss_fns["distillation"] if yaml == "range_augment" else crit).teacher

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)
            teacher = teacher_of(self.criteria)
            before.update({k: v.clone() for k, v in teacher.state_dict().items()})

        def train_epoch(self, epoch):
            stats.append(super().train_epoch(epoch))
            return stats[-1]

    monkeypatch.setattr(main_train, "Trainer", Recorded)
    main_train.main_worker(args=["--common.config-file", os.path.join(REPO, YAMLS[yaml]),
                                 "--common.override-kwargs", *OVERRIDES,
                                 f"common.results_loc={tmp_path}"], device="cpu")
    trainer = built[0]
    teacher = teacher_of(trainer.criteria)
    assert trainer.train_iterations > 0 and all(math.isfinite(v) for v in stats[0].values())
    if yaml == "range_augment":
        assert {"loss.distillation", "loss.neural_augmentation"} <= set(stats[0])
        assert stats[0]["loss.neural_augmentation"] > 0
    # the teacher: not trained, not in the optimizer, the EMA or a checkpoint
    teacher_ids = {id(p) for p in teacher.parameters()}
    in_optimizer = {id(p) for g in trainer.state.optimizer.param_groups for p in g["params"]}
    assert not teacher_ids & in_optimizer
    assert sum(p.numel() for p in trainer.model.parameters()) == sum(
        p.numel() for g in trainer.state.optimizer.param_groups for p in g["params"])
    ema_keys = set(trainer.state.ema.model.state_dict())
    assert ema_keys == set(trainer.model.state_dict())
    blob = load_file(os.path.join(trainer.save_dir, "training_checkpoint_last.pt"))
    assert set(blob["model"]) == set(trainer.model.state_dict()) and set(blob["ema"]) == ema_keys
    assert len(blob["optimizer"]["param_groups"][0]["params"]) + sum(
        len(g["params"]) for g in blob["optimizer"]["param_groups"][1:]) == len(
        list(trainer.model.parameters()))
    assert set(before) == set(teacher.state_dict())
    for key, value in teacher.state_dict().items():
        assert torch.equal(before[key], value), key  # BN statistics too: eval mode
    assert not teacher.training
