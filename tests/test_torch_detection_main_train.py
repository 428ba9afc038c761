"""``cvnets_tpu_torch.main_train`` on ``config/detection/ssd_coco/mobilevit.yaml``,
read from the file, on the CPU over a seeded COCO folder
(``tools/coco_corpus.py``: JPEG files, crowd boxes, an image with no boxes, a
damaged file), 2 epochs, then ``main_eval.main_worker_detection`` on its
validation split with the run's checkpoint. Every yaml setting stays (SSD
crop, photometric distortion, flip, resize, AdamW, cosine, EMA, clip, the
anchors and the matcher) but the dataset's roots, the batch and crop sizes,
the workers, the epochs, the encoder's mode (``xx_small``) and its
projections. The run's losses are finite, its checkpoints written, the
number of classes comes from the dataset, and the evaluation returns COCO
mAPs in [0, 1] at each image's own size (and at the crop size under
``--evaluation.detection.resize-input-images``); its predictions are the
trained model's ``predict`` under the yaml's mixed precision."""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD_YAML = os.path.join(REPO, "config/detection/ssd_coco/mobilevit.yaml")
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import torch_threads  # noqa: E402

MICRO = ["model.classification.mit.mode=xx_small",
         "model.detection.ssd.proj_channels=64,48,48,32,32,32",
         "sampler.bs.crop_size_width=96", "sampler.bs.crop_size_height=96",
         "dataset.train_batch_size0=4", "dataset.val_batch_size0=4",
         "dataset.eval_batch_size0=1", "dataset.workers=2", "scheduler.max_epochs=2",
         "scheduler.warmup_iterations=2"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.tools.coco_corpus import write_coco_corpus

    coco = write_coco_corpus(str(tmp_path_factory.mktemp("coco")), n_train=9, n_val=4,
                             max_side=140, seed=5)
    results = str(tmp_path_factory.mktemp("results"))
    overrides = [f"dataset.root_train={coco}", f"dataset.root_val={coco}",
                 f"common.results_loc={results}", *MICRO]
    trainer = main_train.main_worker(args=["--common.config-file", SSD_YAML,
                                           "--common.override-kwargs", *overrides],
                                     device="cpu")
    return dict(trainer=trainer, coco=coco, overrides=overrides)


def test_ssd_yaml_trains_two_epochs(run):
    trainer = run["trainer"]
    opts = trainer.opts
    for flag in ("ssd_crop", "photo_metric_distort", "random_horizontal_flip", "resize"):
        assert getattr(opts, f"image_augmentation.{flag}.enable"), flag
    assert getattr(opts, "model.detection.n_classes") == 6  # 5 categories + background
    assert trainer.model.ssd_heads[0].n_classes == 6
    assert getattr(opts, "anchor_generator.ssd.output_strides") == [16, 32, 64, 128, 256, -1]
    assert getattr(opts, "common.grad_clip") == 10.0 and trainer.ema_enabled
    assert trainer.train_iterations == trainer.state.step == 4  # 8 images, batch 4, 2 epochs
    files = os.listdir(trainer.save_dir)
    assert {"checkpoint_last.pt", "checkpoint_ema_best.pt"} <= set(files)
    for p in trainer.model.parameters():
        assert torch.isfinite(p).all()


@pytest.mark.parametrize("resize", [False, True])
def test_detection_eval_scores_the_checkpoint(run, resize):
    from cvnets_tpu_torch.main_eval import main_worker_detection

    ckpt = os.path.join(run["trainer"].save_dir, "checkpoint_last.pt")
    extra = ["--evaluation.detection.resize-input-images"] if resize else []
    calls = []
    from cvnets_tpu_torch.engine import eval_detection

    predict = eval_detection.predict

    def spy(opts, model, samples, *a):
        calls.append(tuple(samples.shape))
        return predict(opts, model, samples, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eval_detection, "predict", spy)
        res = main_worker_detection(args=["--common.config-file", SSD_YAML,
                                          "--model.detection.pretrained", ckpt,
                                          "--common.override-kwargs", *run["overrides"],
                                          *extra], device="cpu")
    assert {"bbox", "bbox_50", "bbox_75", "bbox_ar_100"} <= set(res)
    assert all(0.0 <= v <= 1.0 and math.isfinite(v) for v in res.values())
    assert len(calls) == 4  # the val split, one image a batch
    if resize:
        assert set(calls) == {(1, 3, 96, 96)}
    else:
        assert len(set(calls)) > 1  # each image at its own size


def test_eval_predictions_are_the_models(run):
    from cvnets_tpu_torch.engine.eval_detection import predict
    from cvnets_tpu_torch.engine.train_state import UnitNormalizer
    from cvnets_tpu_torch.layers.dtype_utils import autocast

    trainer = run["trainer"]
    model = trainer.model.eval()
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 3, 96, 96))
                         ).to(torch.uint8)
    got = predict(trainer.opts, model, x)
    with autocast(trainer.opts, x.device):  # the yaml's mixed precision
        want = model.predict(UnitNormalizer(trainer.opts)(x))
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got.boxes.shape == (2, 200, 4) and (got.boxes >= 0).all() and (got.boxes <= 1).all()


def test_chip_smoke_flags_are_the_yaml_settings():
    """chip_smoke.py's SSD flag lists set every value the detection yaml gives,
    but the dataset's roots, and nothing the yaml leaves at its default but
    the run's epochs."""
    sys.path.insert(0, REPO)
    from chip_smoke import SSD_ARGS, SSD_DATA_ARGS
    from cvnets_tpu_torch.options.opts import get_training_arguments

    flags = vars(get_training_arguments(args=SSD_ARGS + SSD_DATA_ARGS))
    yaml = vars(get_training_arguments(args=["--common.config-file", SSD_YAML]))
    default = vars(get_training_arguments(args=[]))
    for dest, value in yaml.items():
        if value != default[dest] and dest not in (
                "common.config_file", "taskname", "dataset.root_train", "dataset.root_val"):
            assert flags[dest] == value, dest
    for dest in {k for k, v in flags.items() if v != default[k]}:
        assert flags[dest] == yaml[dest], dest
