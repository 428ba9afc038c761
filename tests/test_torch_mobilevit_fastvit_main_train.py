"""``cvnets_tpu_torch.main_train`` on ``config/classification/imagenet/mobilevit.yaml``
and ``fastvit.yaml``, read from the files, on the CPU with ``--dataset.decoder
native`` (the plain version) over a temporary ImageFolder of JPEG files, 2
epochs, at a small depth: MobileViT ``xx_small`` (the yaml's number-heads 4,
so layer 3's heads have D = 16) and FastViT T8 as the yaml has it. Every yaml
setting stays but the dataset, the batch and crop sizes (the variable batch
sampler draws 48-96 px crops: at 48 px MobileViT's layer 4 and 5 maps are 3
and 2 px, and at 80 px 5 and 3: the resize route), the workers, the epochs
and MobileViT's mode. Each run's statistics are finite and its checkpoints
written; ``chip_smoke.py``'s flag lists of the two yamls are their settings."""

from __future__ import annotations

import math
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = {"mobilevit": os.path.join(REPO, "config/classification/imagenet/mobilevit.yaml"),
         "fastvit": os.path.join(REPO, "config/classification/imagenet/fastvit.yaml")}
sys.path.insert(0, os.path.join(REPO, "tests"))

from test_torch_vit_swin_main_train import folder  # noqa: E402,F401
from torch_port_helpers import torch_threads  # noqa: E402

SMALL = {"mobilevit": ["model.classification.mit.mode=xx_small"], "fastvit": []}
VBS = ["sampler.vbs.crop_size_width=64", "sampler.vbs.crop_size_height=64",
       "sampler.vbs.min_crop_size_width=48", "sampler.vbs.max_crop_size_width=96",
       "sampler.vbs.min_crop_size_height=48", "sampler.vbs.max_crop_size_height=96",
       "sampler.vbs.check_scale=16", "dataset.train_batch_size0=4"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.mark.parametrize("name", ["mobilevit", "fastvit"])
def test_yaml_trains_two_epochs(name, folder, tmp_path):  # noqa: F811
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer

    sizes, stats = [], []

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            step = self._train_step

            def recorded(state, batch, *rest):
                sizes.append(tuple(batch["samples"].shape))
                return step(state, batch, *rest)

            self._train_step = recorded

        def val_epoch(self, epoch, use_ema=False):
            out = super().val_epoch(epoch, use_ema=use_ema)
            stats.append(out)
            return out

    overrides = [f"dataset.root_train={folder}", f"dataset.root_val={folder}",
                 "dataset.name=imagenet", "dataset.decoder=native", "dataset.workers=2",
                 "dataset.val_batch_size0=4", "image_augmentation.resize.size=72",
                 "image_augmentation.center_crop.size=64", "scheduler.max_epochs=2",
                 f"common.results_loc={tmp_path}", *VBS, *SMALL[name]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(main_train, "Trainer", Recorded)
        trainer = main_train.main_worker(args=["--common.config-file", YAMLS[name],
                                               "--common.override-kwargs", *overrides],
                                         device="cpu")
    opts = trainer.opts
    assert getattr(opts, "model.classification.name") == name
    assert getattr(opts, "sampler.name") == "variable_batch_sampler"
    assert getattr(opts, "loss.classification.cross_entropy.label_smoothing") == 0.1
    assert trainer.ema_enabled and getattr(opts, "optim.name") == "adamw"
    assert trainer.train_iterations == len(sizes) > 2 and len({s[2:] for s in sizes}) > 1
    assert len(stats) == 4 and all(math.isfinite(v) for s in stats for v in s.values())
    assert "checkpoint_ema_last.pt" in os.listdir(trainer.save_dir)


@pytest.mark.parametrize("name", ["mobilevit", "fastvit"])
def test_chip_smoke_flags_are_the_yaml_settings(name):
    """chip_smoke.py's flag list of the yaml's main_train run sets every value
    the yaml gives, but the dataset's name and roots, and the run's epochs and
    results."""
    sys.path.insert(0, REPO)
    from chip_smoke import NATIVE_MAIN_TRAIN
    from cvnets_tpu_torch.options.opts import get_training_arguments

    args = NATIVE_MAIN_TRAIN["MobileViT-S" if name == "mobilevit" else "FastViT-T8"]
    flags = vars(get_training_arguments(args=args))
    yaml = vars(get_training_arguments(args=["--common.config-file", YAMLS[name]]))
    default = vars(get_training_arguments(args=[]))

    def same(flag, value):  # a one-entry list of an ``nargs="+"`` flag is its entry
        return flag == value or (isinstance(flag, list) and flag == [value])

    for dest, value in yaml.items():
        if value != default[dest] and dest not in (
                "common.config_file", "taskname", "dataset.root_train", "dataset.root_val",
                "dataset.name", "scheduler.max_epochs"):
            assert same(flags[dest], value), dest
    for dest in {k for k, v in flags.items() if v != default[k]}:
        # the batch sampler's crop is the bare train phase's (the yaml's is vbs)
        assert same(flags[dest], yaml[dest]) or dest in (
            "scheduler.max_epochs", "model.classification.n_classes",
            "sampler.bs.crop_size_width", "sampler.bs.crop_size_height"), dest
