"""Segmentation through the port's entry points on the CPU:
``cvnets_tpu_torch.main_train`` on config/segmentation/ade20k/deeplabv3_mobilevitv2.yaml,
read from the file, with overrides to a CPU test's scale (the port's dummy
segmentation dataset, 64² crops from images of ~60-80 px with short sides
drawn from 48-96, batch 2, 2 loader threads, 2 epochs) and everything else the
yaml's: DeepLabv3-MobileViTv2-1.0 at full width, OS 16, ASPP 512, aux head,
150 classes, SGD with the head's LR ×10, EMA, validation on loss and iou,
checkpoints ranked by iou. Then ``main_worker_segmentation`` on its EMA
checkpoint gives the last EMA validation's iou exactly; a run stopped after
its first epoch resumes and ends with the unbroken run's bits (its crops are
new draws of the epoch's generator); a train-time iou is refused on
head-resolution logits, naming the flag that upsamples them, and trains with
it; an entry point asked for ``cuda`` without a card raises. Also:
chip_smoke.py's segmentation flag lists are the yamls' settings."""

from __future__ import annotations

import math
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEEPLAB_YAML = os.path.join(REPO, "config/segmentation/ade20k/deeplabv3_mobilevitv2.yaml")
PSPNET_YAML = os.path.join(REPO, "config/segmentation/ade20k/pspnet_mobilevitv2.yaml")
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import (  # noqa: E402
    register_port_dummy_segmentation_dataset,
    torch_threads,
)

OVERRIDES = [
    "dataset.name=dummy_segmentation",
    "dataset.train_batch_size0=2",
    "dataset.val_batch_size0=2",
    "dataset.eval_batch_size0=2",
    "dataset.workers=2",
    "sampler.bs.crop_size_width=64",
    "sampler.bs.crop_size_height=64",
    "image_augmentation.random_short_size_resize.short_side_min=48",
    "image_augmentation.random_short_size_resize.short_side_max=96",
    "image_augmentation.random_short_size_resize.max_img_dim=128",
    "scheduler.max_epochs=2",
]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _args(results, extra=()):
    return ["--common.config-file", DEEPLAB_YAML, "--common.override-kwargs", *OVERRIDES,
            f"common.results_loc={results}", *extra]


def _run(results, monkeypatch, max_epochs=None, extra=()):
    """main_train's Trainer, recording its epochs' statistics (and stopping
    after ``max_epochs`` epochs, as a run stopped there)."""
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer

    register_port_dummy_segmentation_dataset()
    built, stats = [], {"train": [], "val": [], "ema": []}

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if max_epochs is not None:
                self.max_epochs = max_epochs
            built.append(self)

        def train_epoch(self, epoch):
            out = super().train_epoch(epoch)
            stats["train"].append(out)
            return out

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


def test_deeplabv3_yaml_trains_two_epochs_and_ranks_checkpoints_by_iou(unbroken):
    trainer, stats = unbroken
    opts = trainer.opts
    assert getattr(opts, "model.segmentation.n_classes") == 150
    assert getattr(opts, "model.classification.mitv2.width_multiplier") == 1.0
    assert getattr(opts, "stats.checkpoint_metric") == "iou"
    assert trainer.train_iterations == trainer.state.step == 8  # 2 epochs of 8 / 2
    assert len(stats["val"]) == len(stats["ema"]) == 2
    for s in stats["val"] + stats["ema"]:
        assert set(s) == {"loss", "iou"} and 0.0 <= s["iou"] <= 100.0
        assert all(math.isfinite(v) for v in s.values())
    assert set(stats["train"][0]) == {"loss", "loss.seg_loss", "loss.aux_loss"}
    assert trainer.ckpt_manager.best_metric == max(s["iou"] for s in stats["val"])
    files = set(os.listdir(trainer.save_dir))
    assert {"checkpoint_best.pt", "checkpoint_ema_last.pt",
            "training_checkpoint_last.pt"} <= files


def test_main_worker_segmentation_gives_the_last_ema_validation_iou(unbroken, tmp_path):
    from cvnets_tpu_torch.main_eval import main_worker_segmentation

    trainer, stats = unbroken
    ckpt = os.path.join(trainer.save_dir, "checkpoint_ema_last.pt")
    miou = main_worker_segmentation(args=_args(tmp_path, [
        f"model.segmentation.pretrained={ckpt}",
        "evaluation.segmentation.resize_input_images_fixed_size=64,64"]), device="cpu")
    assert miou == stats["ema"][-1]["iou"]


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
    assert resumed_stats["ema"][-1] == whole_stats["ema"][-1]


def test_a_train_iou_needs_full_resolution_logits(tmp_path, monkeypatch):
    """ROADMAP queue 3 fault 1: refused when the Trainer is built, with the
    flag named; with ``--model.segmentation.upsample-train-logits`` it trains
    and reports a train iou."""
    train_iou = ["stats.train=loss,iou", "scheduler.max_epochs=1",
                 "model.classification.mitv2.width_multiplier=0.5",
                 "model.segmentation.deeplabv3.aspp_out_channels=32"]
    with pytest.raises(ValueError, match="--model.segmentation.upsample-train-logits"):
        _run(tmp_path / "refused", monkeypatch, extra=train_iou)
    trainer, stats = _run(tmp_path / "upsampled", monkeypatch, extra=train_iou + [
        "model.segmentation.upsample_train_logits=true"])
    assert trainer.train_iterations == 4
    train = stats["train"][-1]
    assert {"loss", "iou"} <= set(train) and 0.0 <= train["iou"] <= 100.0


def test_chip_smoke_segmentation_flags_are_the_yaml_settings():
    """chip_smoke.py's DeepLabv3 main_train flags (DEEPLAB_ARGS and its data
    flags) and its PSPNet flags give what the two ADE20k yamls give, but the
    dataset's name and roots, the batch (the yaml's 4 a GPU × 2), the epochs
    and the run's own settings."""
    sys.path.insert(0, REPO)
    from chip_smoke import PSPNET_ARGS, SEG_MAIN_TRAIN_ARGS
    from cvnets_tpu_torch.options.opts import get_training_arguments

    default = vars(get_training_arguments(args=[]))
    own = {"common.config_file", "taskname", "dataset.root_train", "dataset.root_val",
           "dataset.name", "scheduler.max_epochs", "dataset.train_batch_size0",
           "dataset.val_batch_size0", "dataset.eval_batch_size0", "dataset.workers",
           "common.seed", "common.run_label", "common.log_freq", "common.auto_resume",
           "common.mixed_precision_dtype", "model.segmentation.classifier_dropout",
           "model.segmentation.aux_dropout"}

    def same(flag, value):  # a one-entry list of an ``nargs="+"`` flag is its entry
        return flag == value or (isinstance(flag, list) and flag == [value])

    for args, yaml_path in ((SEG_MAIN_TRAIN_ARGS, DEEPLAB_YAML), (PSPNET_ARGS, PSPNET_YAML)):
        flags = vars(get_training_arguments(args=args))
        yaml = vars(get_training_arguments(args=["--common.config-file", yaml_path]))
        for dest, value in yaml.items():
            if value != default[dest] and dest not in own:
                assert same(flags[dest], value), (yaml_path, dest)
        for dest, value in flags.items():
            if value != default[dest] and dest not in own:
                assert same(value, yaml[dest]), (yaml_path, dest)


def test_main_worker_segmentation_asking_for_cuda_without_a_card_raises(tmp_path):
    from cvnets_tpu_torch.main_eval import main_worker_segmentation

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    register_port_dummy_segmentation_dataset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_worker_segmentation(args=_args(tmp_path))  # the default device is cuda
    assert not os.listdir(tmp_path)
