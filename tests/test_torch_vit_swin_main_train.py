"""``cvnets_tpu_torch.main_train`` on ``config/classification/imagenet/vit.yaml``
and ``swin.yaml``, read from the files, on the CPU with ``--dataset.decoder
native`` (the plain version) over a temporary ImageFolder of JPEG files that
Pillow writes, at micro width (the micro ViT, the micro Swin of
``torch_port_helpers``), 2 epochs. Every yaml setting stays but the dataset,
the batch and crop sizes, the workers, the epochs and the model's mode:

* vit.yaml: the variable batch sampler draws a crop of 32-96 px and its batch
  every batch under RandAugment, random erasing, mixup and cutmix; every train
  batch goes through the native route at its own size;
* swin.yaml: the batch sampler at 64 px, the same augmentation, stochastic
  depth 0.2;
* each run's statistics are finite, its checkpoints written, and the routes
  logged; ``chip_smoke.py``'s flag lists of the two yamls are their settings.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = {"vit": os.path.join(REPO, "config/classification/imagenet/vit.yaml"),
         "swin": os.path.join(REPO, "config/classification/imagenet/swin.yaml")}
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import micro_swin_modes, torch_threads  # noqa: E402

MICRO = {
    "vit": ["model.classification.vit.mode=micro",
            "sampler.vbs.crop_size_width=64", "sampler.vbs.crop_size_height=64",
            "sampler.vbs.min_crop_size_width=32", "sampler.vbs.max_crop_size_width=96",
            "sampler.vbs.min_crop_size_height=32", "sampler.vbs.max_crop_size_height=96",
            "sampler.vbs.check_scale=16", "dataset.train_batch_size0=4"],
    "swin": ["model.classification.swin.mode=micro", "sampler.bs.crop_size_width=64",
             "sampler.bs.crop_size_height=64", "dataset.train_batch_size0=4"],
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """3 classes × 8 JPEGs of 60-110 px (4:2:0, every third 4:4:4)."""
    import io

    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet_jpegs")
    rng = np.random.default_rng(11)
    for c in range(3):
        (root / f"n0{c}").mkdir()
        for i in range(8):
            h, w = int(rng.integers(60, 111)), int(rng.integers(60, 111))
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                buf, "JPEG", quality=90, subsampling=0 if i % 3 == 2 else 2)
            (root / f"n0{c}" / f"img_{i}.jpg").write_bytes(buf.getvalue())
    return str(root)


def _run(name, folder, results):
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer

    built, sizes, stats = [], [], []

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            step = self._train_step

            def recorded(state, batch, *rest):
                sizes.append(tuple(batch["samples"].shape))
                return step(state, batch, *rest)

            self._train_step = recorded
            built.append(self)

        def val_epoch(self, epoch, use_ema=False):
            out = super().val_epoch(epoch, use_ema=use_ema)
            stats.append(out)
            return out

    overrides = [f"dataset.root_train={folder}", f"dataset.root_val={folder}",
                 "dataset.name=imagenet", "dataset.decoder=native", "dataset.workers=2",
                 "dataset.val_batch_size0=4", "image_augmentation.resize.size=72",
                 "image_augmentation.center_crop.size=64", "scheduler.max_epochs=2",
                 f"common.results_loc={results}", *MICRO[name]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(main_train, "Trainer", Recorded)
        trainer = main_train.main_worker(args=["--common.config-file", YAMLS[name],
                                               "--common.override-kwargs", *overrides],
                                         device="cpu")
    assert trainer is built[-1]
    return trainer, sizes, stats


@pytest.mark.parametrize("name", ["vit", "swin"])
def test_yaml_trains_two_epochs_through_the_native_route(name, folder, tmp_path, monkeypatch):
    from cvnets_tpu_torch.data.datasets.classification import (
        base_image_classification_dataset as dataset_module,
    )

    routed = []
    fetch = dataset_module.BaseImageClassificationDataset.fetch_batch_native

    def counted(self, batch_tuples, *a, **k):
        out = fetch(self, batch_tuples, *a, **k)
        routed.append(tuple(out["samples"].shape))
        return out

    monkeypatch.setattr(dataset_module.BaseImageClassificationDataset, "fetch_batch_native",
                        counted)
    with micro_swin_modes():
        trainer, sizes, stats = _run(name, folder, tmp_path)
    opts = trainer.opts
    for flag in ("random_resized_crop", "random_horizontal_flip", "rand_augment",
                 "random_erase", "mixup", "cutmix"):
        assert getattr(opts, f"image_augmentation.{flag}.enable"), flag
    assert getattr(opts, "dataset.decoder") == "native"
    assert trainer.train_iterations == trainer.state.step == len(sizes) == len(routed) > 2
    assert sizes == routed  # every train batch through the native route
    if name == "vit":
        assert getattr(opts, "sampler.name") == "variable_batch_sampler"
        assert len({s[2:] for s in sizes}) > 1 and len({s[0] for s in sizes}) > 1
    else:
        assert getattr(opts, "model.classification.swin.stochastic_depth_prob") == 0.2
        assert {s[1:] for s in sizes} == {(3, 64, 64)}
    assert len(stats) == 4 and all(math.isfinite(v) for s in stats for v in s.values())
    assert "checkpoint_ema_last.pt" in os.listdir(trainer.save_dir)


@pytest.mark.parametrize("name", ["vit", "swin"])
def test_chip_smoke_flags_are_the_yaml_settings(name):
    """chip_smoke.py's flag list of the yaml's native main_train run sets every
    value the yaml gives, but the dataset's name and roots, and the run's
    epochs and results."""
    sys.path.insert(0, REPO)
    from chip_smoke import NATIVE_MAIN_TRAIN
    from cvnets_tpu_torch.options.opts import get_training_arguments

    args = NATIVE_MAIN_TRAIN["ViT-B/16" if name == "vit" else "Swin-T"]
    default = vars(get_training_arguments(args=[]))
    flags = vars(get_training_arguments(args=args))
    yaml = vars(get_training_arguments(args=["--common.config-file", YAMLS[name]]))

    def same(flag, value):  # a one-entry list of an ``nargs="+"`` flag is its entry
        return flag == value or (isinstance(flag, list) and flag == [value])

    for dest, value in yaml.items():
        if value != default[dest] and dest not in (
                "common.config_file", "taskname", "dataset.root_train", "dataset.root_val",
                "dataset.name", "scheduler.max_epochs"):
            assert same(flags[dest], value), dest
    for dest in {k for k, v in flags.items() if v != default[k]}:
        assert same(flags[dest], yaml[dest]) or dest in (
            "scheduler.max_epochs", "model.classification.n_classes",
            "sampler.bs.crop_size_width", "sampler.bs.crop_size_height",
            "dataset.train_batch_size0"), dest
