"""The port's ImageNet shift sets and Places365 against the JAX package's
(cvnets_tpu/data/datasets/classification/imagenet.py:14-115), on small folder
trees of PNG files that Pillow writes:

* ``imagenet_a``, ``imagenet_r`` and ``imagenet_sketch``: the same classes,
  samples and labels, and the same ``stats.logit_subset_indices`` from the
  training root's wnids and from ``--dataset.imagenet-shift.wnid-file``; none
  when a class is not among ImageNet's;
* ``imagenet_v2``: its numeric folders relabelled by their number, the split's
  folder under the root (``--dataset.imagenet-v2.split``) or the root itself;
* ``places365``: an ImageFolder;
* the Evaluator keeps the logits of the subset's classes, as the JAX eval step
  does (train_state.py:297-302).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

WNIDS = [f"n{i:08d}" for i in (7, 3, 11, 5, 2, 13, 17, 19)]  # the "ImageNet" classes


def _tree(root, classes, per_class=2):
    rng = np.random.default_rng(len(classes))
    for c in classes:
        (root / c).mkdir(parents=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, (8, 10, 3), dtype=np.uint8)).save(
                root / c / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("shift")
    out = {"train": _tree(base / "train", WNIDS),
           "shift": _tree(base / "shift", [WNIDS[5], WNIDS[1], WNIDS[6]]),
           "foreign": _tree(base / "foreign", [WNIDS[1], "n99999999"]),
           "v2": _tree(base / "v2" / "imagenetv2-top-images-format-val",
                       [str(i) for i in (0, 1, 2, 10, 11)]),
           "places": _tree(base / "places", ["airfield", "bakery", "canyon"])}
    out["v2_root"] = str(base / "v2")
    wnid_file = base / "wnids.txt"
    wnid_file.write_text("\n".join(sorted(WNIDS)[::-1]) + "\n")
    out["wnid_file"] = str(wnid_file)
    return out


def _pair(name, root, train_root, extra=()):
    from cvnets_tpu.data.datasets import build_dataset_from_registry as jax_build
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.data.datasets import build_dataset_from_registry as port_build
    from cvnets_tpu_torch.options.opts import get_training_arguments as port_args

    args = ["--dataset.name", name, "--dataset.category", "classification",
            "--dataset.root-train", train_root, "--dataset.root-val", root,
            "--dataset.decoder", "pil", *extra]
    return (jax_build(jax_args(args=args), is_training=False),
            port_build(port_args(args=args), is_training=False))


def _same(ref, port):
    assert port.classes == ref.classes
    assert [(str(p), t) for p, t in port.samples] == [(str(p), t) for p, t in ref.samples]
    assert port.share_dataset_arguments() == ref.share_dataset_arguments()


@pytest.mark.parametrize("name", ["imagenet_a", "imagenet_r", "imagenet_sketch"])
@pytest.mark.parametrize("source", ["train_root", "wnid_file"])
def test_shift_sets_map_their_classes_as_the_jax_package(trees, name, source):
    extra = ["--dataset.imagenet-shift.wnid-file", trees["wnid_file"]] \
        if source == "wnid_file" else []
    ref, port = _pair(name, trees["shift"], trees["train"], extra)
    _same(ref, port)
    full = sorted(WNIDS)[::-1] if source == "wnid_file" else sorted(WNIDS)
    assert port.share_dataset_arguments() == {
        "stats.logit_subset_indices": [full.index(c) for c in port.classes]}


def test_a_class_outside_imagenet_gives_no_subset(trees):
    ref, port = _pair("imagenet_a", trees["foreign"], trees["train"])
    _same(ref, port)
    assert port.share_dataset_arguments() == {}


@pytest.mark.parametrize("split", [None, "top-images"])
def test_imagenet_v2_relabels_its_numeric_folders(trees, split):
    root = trees["v2"] if split is None else trees["v2_root"]
    extra = [] if split is None else ["--dataset.imagenet-v2.split", split]
    ref, port = _pair("imagenet_v2", root, trees["train"], extra)
    _same(ref, port)
    assert port.classes == ["0", "1", "2", "10", "11"]
    assert sorted({t for _, t in port.samples}) == [0, 1, 2, 10, 11]
    assert all(p.split("/")[-2] == str(t) for p, t in port.samples)


def test_places365_is_an_image_folder(trees):
    ref, port = _pair("places365", trees["places"], trees["train"])
    _same(ref, port)
    assert port.share_dataset_arguments() == {"model.classification.n_classes": 3}


def test_evaluator_keeps_the_subset_logits(trees):
    from cvnets_tpu_torch.engine import Evaluator
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=["--stats.val", "loss", "top1"])
    setattr(opts, "stats.logit_subset_indices", [5, 1, 6])

    class Linear(torch.nn.Module):
        def forward(self, x):
            return x.flatten(1)[:, :8] * 10.0

    x = torch.zeros((3, 3, 2, 2))
    for row, cls in enumerate((5, 1, 6)):  # each row's largest logit is its class's
        x.view(3, -1)[row, cls] = 1.0
    batches = [{"samples": x, "targets": torch.tensor([0, 1, 2])}]
    stats = Evaluator(opts, Linear(), batches, device="cpu").eval_fn_image()
    assert stats["top1"] == 100.0
