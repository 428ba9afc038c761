"""Mask R-CNN through the port's entry points on the CPU:

* the 11 shipped Mask R-CNN yamls build (``tools/yaml_probe.py``: parser,
  ``get_model`` on ``meta``, scheduler, loss, dataset);
* ``cvnets_tpu_torch.main_train`` on ``config/detection/mask_rcnn_coco/vit_fpn.yaml``,
  read from the file, over a seeded COCO folder with polygons
  (``tools/coco_corpus.py``), 2 epochs: every yaml setting stays (MobileViTv2,
  AdamW, multi_step with warm-up, EMA, clip 1.0, the backbone's LR ×0.7,
  resize and flip) but the roots, the batch and crop sizes, the workers,
  the epochs and warm-up, the widths and proposal counts, and mixed
  precision (off: float32 on the CPU). The five losses are finite, and a run
  stopped after its first epoch resumes (the yaml's ``auto_resume``) and ends
  with the unbroken run's bits;
* ``main_eval.main_worker_detection`` with ``--stats.coco-map.iou-types bbox
  segm`` on the run's checkpoint: box and mask mAPs in [0, 1];
* ``chip_smoke.py``'s flags of the two paths are the yamls' settings.
"""

from __future__ import annotations

import math
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_A = os.path.join(REPO, "config/detection/mask_rcnn_coco/vit_fpn.yaml")
YAML_B = os.path.join(REPO, "config/detection/mask_rcnn_coco/vit_fpn_lsj.yaml")
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import torch_threads  # noqa: E402

MASK_RCNN_YAMLS = ["config/detection/mask_rcnn_coco/" + n + ".yaml"
                   for n in ("resnet_fpn", "vit_fpn", "vit_fpn_lsj")] + [
    "examples/range_augment/detection/maskrcnn_" + n + ".yaml"
    for n in ("efficientnet_b3", "mobilenet_v1", "mobilenet_v2", "mobilenet_v3", "mobilevit",
              "resnet_101", "resnet_50")] + [
    "examples/vit/detection/mask_rcnn_vit_base_clip.yaml"]
MICRO = ["model.classification.mitv2.width_multiplier=0.5",
         "model.detection.mask_rcnn.fpn_out_channels=32",
         "model.detection.mask_rcnn.pre_nms_top_n=64",
         "model.detection.mask_rcnn.post_nms_top_n=16",
         "model.detection.mask_rcnn.box_batch_per_image=16",
         "model.detection.mask_rcnn.mask_positives=4",
         "model.detection.mask_rcnn.detections_per_image=8",
         "sampler.bs.crop_size_width=96", "sampler.bs.crop_size_height=96",
         "image_augmentation.resize.size=96",
         "dataset.train_batch_size0=2", "dataset.val_batch_size0=2",
         "dataset.eval_batch_size0=2", "dataset.workers=2",
         "scheduler.warmup_iterations=2", "common.mixed_precision=false", "common.log_freq=2"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.mark.parametrize("yaml", MASK_RCNN_YAMLS)
def test_mask_rcnn_yamls_build(yaml):
    from cvnets_tpu_torch.tools.yaml_probe import probe

    assert probe(os.path.join(REPO, yaml)) is None


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from cvnets_tpu_torch.tools.coco_corpus import write_coco_corpus

    return write_coco_corpus(str(tmp_path_factory.mktemp("coco")), n_train=8, n_val=4,
                             max_side=120, seed=3)


def _overrides(coco, results, epochs: int = 2):
    return [f"dataset.root_train={coco}", f"dataset.root_val={coco}",
            f"common.results_loc={results}", f"scheduler.max_epochs={epochs}", *MICRO]


def _train(coco, results, epochs: int = 2):
    """The Trainer of a run and each training epoch's statistics."""
    import cvnets_tpu_torch.main_train as main_train

    logs = []

    class Recording(main_train.Trainer):
        def train_epoch(self, epoch):
            logs.append(super().train_epoch(epoch))
            return logs[-1]

    main_train.Trainer = Recording
    try:
        trainer = main_train.main_worker(args=["--common.config-file", YAML_A,
                                               "--common.override-kwargs",
                                               *_overrides(coco, results, epochs)],
                                         device="cpu")
    finally:
        main_train.Trainer = Recording.__bases__[0]
    return trainer, logs


@pytest.fixture(scope="module")
def unbroken(coco, tmp_path_factory):
    results = str(tmp_path_factory.mktemp("whole"))
    trainer, logs = _train(coco, results)
    return trainer, logs, results


def test_vit_fpn_yaml_trains_two_epochs_and_resumes_bit_identical(coco, unbroken, tmp_path):
    whole, logs, _ = unbroken
    assert whole.train_iterations == 8 and whole.model.n_detection_classes == 6
    assert whole.model.backbone_lr_multiplier == 0.7
    assert {group["lr_mult"] for group in whole.state.optimizer.param_groups} == {0.7, 1.0}
    assert len(logs) == 2
    for log in logs:
        assert {"loss", "loss.loss_objectness", "loss.loss_rpn_box_reg", "loss.loss_classifier",
                "loss.loss_box_reg", "loss.loss_mask"} <= set(log)
        assert all(math.isfinite(v) for v in log.values()), log
    for p in whole.model.parameters():
        assert bool(torch.isfinite(p).all())
    first, _ = _train(coco, str(tmp_path), epochs=1)
    assert first.train_iterations == 4
    resumed, _ = _train(coco, str(tmp_path))  # the yaml's auto_resume
    assert (resumed.start_epoch, resumed.state.step) == (1, 8)
    for a, b in ((whole.model, resumed.model), (whole.state.ema.model, resumed.state.ema.model)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), key


def test_detection_eval_scores_boxes_and_masks(coco, unbroken):
    from cvnets_tpu_torch.main_eval import main_worker_detection

    whole, _, results = unbroken
    ckpt = os.path.join(whole.save_dir, "checkpoint_last.pt")
    res = main_worker_detection(args=["--common.config-file", YAML_A,
                                      "--common.override-kwargs",
                                      *_overrides(coco, results),
                                      "--model.detection.pretrained", ckpt,
                                      "--stats.coco-map.iou-types", "bbox", "segm"],
                                device="cpu")
    assert {"bbox", "bbox_50", "segm", "segm_50", "segm_small"} <= set(res)
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())


@pytest.mark.parametrize("name,yaml", [("MASK_RCNN_A_ARGS", YAML_A),
                                       ("MASK_RCNN_B_ARGS", YAML_B)])
def test_chip_smoke_flags_are_the_yaml_settings(name, yaml):
    """Every value of chip_smoke.py's flag lists of the two paths is the one
    its yaml gives, but the dataset's roots (the card machine has no COCO),
    and nothing the yaml sets is left out but those roots."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from cvnets_tpu_torch.options.opts import get_training_arguments

    flags = vars(get_training_arguments(args=getattr(chip_smoke, name)))
    want = vars(get_training_arguments(args=["--common.config-file", yaml]))
    for dest, value in want.items():
        if dest in ("common.config_file", "taskname") or dest.startswith("dataset.root_"):
            continue
        assert flags[dest] == value, dest
