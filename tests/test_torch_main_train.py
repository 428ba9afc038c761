"""The port's entry points on the CPU (the verify skill's surface 2 for the
port): ``cvnets_tpu_torch.main_train`` on the flagship yaml, read from the file,
trains 2 epochs at MobileViTv2-1.0's full width with every augmentation the yaml
turns on (random resized crop, flip, RandAugment, random erasing, mixup,
cutmix), on the port's copy of the dummy dataset at 64 px, batch 4 and 16
samples; ``main_eval`` reads its checkpoint and gives its last EMA validation;
a run stopped after its first epoch resumes and ends with the unbroken run's
bits. Also: ``chip_smoke.py``'s flag list of its main_train phase is the yaml's
settings, and a run that asks for ``cuda`` without a card raises."""

from __future__ import annotations

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_YAML = os.path.join(REPO, "config/classification/imagenet/mobilevit_v2.yaml")
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import (  # noqa: E402
    FLAGSHIP_DUMMY_OVERRIDES,
    register_port_dummy_dataset,
    torch_threads,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _args(results, extra=()):
    return ["--common.config-file", FLAGSHIP_YAML, "--common.override-kwargs",
            *FLAGSHIP_DUMMY_OVERRIDES, f"common.results_loc={results}", *extra]


def _run(results, monkeypatch, max_epochs=None, extra=()):
    """main_train's Trainer, recording its validation epochs (and stopping after
    ``max_epochs`` epochs, as a run stopped there)."""
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer

    register_port_dummy_dataset()
    built, stats = [], {"val": [], "ema": []}

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if max_epochs is not None:
                self.max_epochs = max_epochs
            built.append(self)

        def val_epoch(self, epoch, use_ema=False):
            out = super().val_epoch(epoch, use_ema=use_ema)
            stats["ema" if use_ema else "val"].append(out)
            return out

    monkeypatch.setattr(main_train, "Trainer", Recorded)
    trainer = main_train.main_worker(args=_args(results, extra), device="cpu")
    assert trainer is built[-1]
    return trainer, stats


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        return _run(tmp_path_factory.mktemp("whole"), mp)


def test_flagship_yaml_trains_two_epochs_with_every_augmentation(unbroken):
    import math

    trainer, stats = unbroken
    opts = trainer.opts
    for flag in ("random_resized_crop", "random_horizontal_flip", "rand_augment",
                 "random_erase", "mixup", "cutmix"):
        assert getattr(opts, f"image_augmentation.{flag}.enable"), flag
    assert getattr(opts, "model.classification.mitv2.width_multiplier") == 1.0
    assert trainer.train_iterations == trainer.state.step == 8  # 2 epochs of 16 / 4
    assert trainer.train_loader.batch_sampler.epoch == 1
    assert len(stats["val"]) == len(stats["ema"]) == 2
    assert all(math.isfinite(v) for s in stats["val"] + stats["ema"] for v in s.values())
    files = set(os.listdir(trainer.save_dir))
    assert {"checkpoint_ema_last.pt", "training_checkpoint_last.pt", "config.yaml"} <= files


def test_main_eval_reads_the_checkpoint_and_gives_the_last_ema_validation(unbroken):
    from cvnets_tpu_torch.main_eval import main_worker

    trainer, stats = unbroken
    ckpt = os.path.join(trainer.save_dir, "checkpoint_ema_last.pt")
    got = main_worker(args=_args(os.path.dirname(trainer.save_dir),
                                 [f"model.classification.pretrained={ckpt}"]), device="cpu")
    assert got == stats["ema"][-1]
    # --common.resume with the training checkpoint reads its model part
    resume = os.path.join(trainer.save_dir, "training_checkpoint_last.pt")
    got = main_worker(args=_args(os.path.dirname(trainer.save_dir),
                                 [f"common.resume={resume}"]), device="cpu")
    assert got == stats["val"][-1]


def test_a_run_stopped_after_its_first_epoch_resumes_bit_identical(unbroken, tmp_path,
                                                                   monkeypatch):
    whole, whole_stats = unbroken
    first, _ = _run(tmp_path, monkeypatch, max_epochs=1)
    assert first.train_iterations == 4
    resumed, resumed_stats = _run(tmp_path, monkeypatch)  # the yaml's auto_resume
    assert (resumed.start_epoch, resumed.state.step) == (1, 8)
    for a, b in ((whole.model, resumed.model), (whole.state.ema.model, resumed.state.ema.model)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), key
    opt_a, opt_b = whole.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i, st in opt_a["state"].items():
        assert all(torch.equal(st[k], opt_b["state"][i][k]) for k in st), i
    assert resumed_stats["ema"][-1] == whole_stats["ema"][-1]


def test_chip_smoke_main_train_flags_are_the_yaml_settings():
    """Every value chip_smoke.py's MAIN_TRAIN_ARGS set is the one the flagship
    yaml gives, but its dataset's name and the epoch count (2 of the yaml's
    300), and nothing the yaml sets is left out but the dataset's roots and
    name (the yaml's ImageNet on disk)."""
    sys.path.insert(0, REPO)
    from chip_smoke import MAIN_TRAIN_ARGS
    from cvnets_tpu_torch.options.opts import get_training_arguments

    default = vars(get_training_arguments(args=[]))
    flags = vars(get_training_arguments(args=MAIN_TRAIN_ARGS))
    yaml = vars(get_training_arguments(args=["--common.config-file", FLAGSHIP_YAML]))
    set_by_flags = {k for k, v in flags.items() if v != default[k]}
    assert {"image_augmentation.rand_augment.enable", "image_augmentation.cutmix.enable",
            "image_augmentation.resize.size", "dataset.workers"} <= set_by_flags
    def same(flag, value):  # a one-entry list of an ``nargs="+"`` flag is its entry
        return flag == value or (isinstance(flag, list) and flag == [value])

    for dest in sorted(set_by_flags - {"dataset.name", "scheduler.max_epochs"}):
        assert same(flags[dest], yaml[dest]), dest
    for dest, value in yaml.items():
        if value != default[dest] and dest not in (
                "common.config_file", "taskname", "dataset.root_train", "dataset.root_val",
                "dataset.name", "scheduler.max_epochs"):
            assert same(flags[dest], value), dest


@pytest.mark.parametrize("entry", ["main_train", "main_eval"])
def test_an_entry_point_asking_for_cuda_without_a_card_raises(entry, tmp_path):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    register_port_dummy_dataset()
    module = importlib.import_module(f"cvnets_tpu_torch.{entry}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main_worker(args=_args(tmp_path))  # the default device is cuda
    assert not os.listdir(tmp_path)  # nothing ran
