"""``cvnets_tpu_torch.main_train`` on
``config/video_classification/kinetics/mobilevit_st_small.yaml``, read from
the file, on the CPU over a temporary Kinetics tree of JPEG frame folders
(3 classes, 4 videos each, 7-13 frames), one epoch, then
``main_eval`` of its checkpoint. Every yaml setting stays but the dataset
roots, the batch, crop and clip sizes (2 videos of 2 clips of 3 frames at
64², against the yaml's 8 × 8 × 256²), the workers, the epochs, the class
count and MobileViT's mode (``xx_small``). Training trains each clip as a
sample; validation and ``main_eval`` vote over a video's two clips.
Checked: the batches' shapes, finite statistics, checkpoints written, the
EMA, and ``main_eval``'s top-1 of the EMA checkpoint equal to the
Trainer's EMA validation of the same weights."""

from __future__ import annotations

import math
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "config/video_classification/kinetics/mobilevit_st_small.yaml")
sys.path.insert(0, os.path.join(REPO, "tests"))

from test_torch_video_data import write_video  # noqa: E402
from torch_port_helpers import torch_threads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def test_yaml_trains_an_epoch_and_main_eval_votes_over_clips(tmp_path):
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.main_eval import main_worker as main_eval

    for c in range(3):
        for v in range(4):
            write_video(tmp_path / "kinetics" / f"class_{c}" / f"video_{v}", 7 + 2 * v,
                        hw=(72, 80), seed=10 * c + v)
    root = str(tmp_path / "kinetics")
    shapes, stats = [], []

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            step = self._train_step

            def recorded(state, batch, *rest):
                shapes.append(tuple(batch["samples"].shape))
                return step(state, batch, *rest)

            self._train_step = recorded

        def val_epoch(self, epoch, use_ema=False):
            out = super().val_epoch(epoch, use_ema=use_ema)
            stats.append(out)
            return out

    overrides = [f"dataset.root_train={root}", f"dataset.root_val={root}",
                 "dataset.workers=2", "dataset.train_batch_size0=2",
                 "dataset.val_batch_size0=2", "video_reader.frames_per_clip=3",
                 "video_reader.clips_per_video=2", "sampler.bs.crop_size_width=64",
                 "sampler.bs.crop_size_height=64", "scheduler.max_epochs=1",
                 "model.video_classification.n_classes=3",
                 "model.classification.mit.mode=xx_small", "common.mixed_precision=false",
                 f"common.results_loc={tmp_path / 'results'}"]
    args = ["--common.config-file", YAML, "--common.override-kwargs", *overrides]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(main_train, "Trainer", Recorded)
        trainer = main_train.main_worker(args=args, device="cpu")
    opts = trainer.opts
    assert getattr(opts, "dataset.name") == "kinetics" and getattr(opts, "optim.name") == "sgd"
    assert getattr(opts, "video_reader.name") == "frame_folder" and trainer.ema_enabled
    assert getattr(opts, "dataset.pin_memory") and getattr(opts, "dataset.persistent_workers")
    assert shapes == [(2, 2, 3, 3, 64, 64)] * 6
    assert len(stats) == 2 and all(math.isfinite(v) for s in stats for v in s.values())
    assert set(stats[0]) == {"loss", "top1", "top5"} and stats[0]["loss"] == 0.0
    run_dir = os.path.join(str(tmp_path / "results"), "train")
    assert {"checkpoint_last.pt", "checkpoint_ema_last.pt"} <= set(os.listdir(run_dir))

    evaluated = main_eval(args=args + [
        "--model.video-classification.pretrained",
        os.path.join(run_dir, "checkpoint_ema_last.pt"), "--dataset.eval-batch-size0", "2",
        "--common.inference-modality", "video"], device="cpu")
    assert evaluated["top1"] == pytest.approx(stats[1]["top1"], abs=1e-6)


def test_chip_smoke_flags_are_the_yaml():
    """chip_smoke.py's ``VIDEO_ARGS`` parse to the yaml's values but for its
    data roots; ``VIDEO_V2_ARGS`` swap the encoder for MobileViTv2-1.0."""
    sys.path.insert(0, REPO)
    from chip_smoke import VIDEO_ARGS, VIDEO_V2_ARGS, path_opts
    from torch_port_helpers import flags_differ_from_yaml

    assert flags_differ_from_yaml(path_opts(VIDEO_ARGS), YAML) == [
        "common.config_file", "dataset.root_train", "dataset.root_val", "taskname"]
    assert flags_differ_from_yaml(path_opts(VIDEO_V2_ARGS), YAML) == [
        "common.config_file", "dataset.root_train", "dataset.root_val",
        "model.classification.name", "taskname"]
