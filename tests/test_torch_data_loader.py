"""The port's classification data path against the JAX package's, on a
temporary ImageFolder of PNG and JPEG files that Pillow writes (and one file
that is not an image):

* ``ImageNetDataset``: the same classes, samples and training subsets
  (``--dataset.percentage-of-samples``, ``--dataset.num-samples-per-category``);
* the unreadable file read as zeros with label -1, then replaced in its batch
  by the collate as the JAX collate replaces it;
* ``create_train_val_loader`` and ``create_test_loader``: every batch of two
  training epochs and of the validation and test loaders equals the JAX
  loader's collated batch (NHWC float / 255 there, NCHW uint8 here) within
  one uint8 level (the two resamplers, 1/255), labels and sample ids exactly,
  with 0 worker threads and with 3. The JAX transforms draw from the global
  ``random``, seeded here as the port's loader seeds its epoch's
  ``random.Random``; the JAX dataset reads through Pillow
  (``--dataset.decoder pil``), as the port does;
* an error in a worker reaches the consumer; without Pillow, reading an image
  on the per-sample route raises and says that Pillow is needed.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch
from PIL import Image

from cvnets_tpu.options.opts import get_training_arguments as jax_args
from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

CLASSES = ["n01", "n02", "n03"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.default_rng(0)
    for c, name in enumerate(CLASSES):
        (root / name).mkdir()
        for i in range(5 + c):
            hw = (int(rng.integers(36, 90)), int(rng.integers(36, 90)))
            img = Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
            if i % 2:
                img.save(root / name / f"img_{i}.png")
            else:
                img.save(root / name / f"img_{i}.JPEG", quality=90)
    (root / "n02" / "img_9.jpg").write_bytes(b"not an image")  # the corrupt sample
    (root / "n02" / "notes.txt").write_text("not a sample")
    return str(root)


def _args(folder, extra=()):
    return ["--dataset.name", "imagenet", "--dataset.category", "classification",
            "--dataset.root-train", folder, "--dataset.root-val", folder,
            "--dataset.decoder", "pil", "--dataset.train-batch-size0", "4",
            "--dataset.val-batch-size0", "3", "--dataset.eval-batch-size0", "5",
            "--sampler.bs.crop-size-width", "32", "--sampler.bs.crop-size-height", "32",
            "--image-augmentation.random-resized-crop.enable",
            "--image-augmentation.random-resized-crop.interpolation", "bicubic",
            "--image-augmentation.random-horizontal-flip.enable",
            "--image-augmentation.resize.enable", "--image-augmentation.resize.size", "40",
            "--image-augmentation.resize.interpolation", "bicubic",
            "--image-augmentation.center-crop.enable",
            "--image-augmentation.center-crop.size", "32", "--common.seed", "3", *extra]


def _datasets(folder, extra=(), is_training=True):
    from cvnets_tpu.data.datasets.classification.imagenet import ImageNetDataset as JaxImageNet
    from cvnets_tpu_torch.data.datasets.classification.imagenet import ImageNetDataset

    args = _args(folder, extra)
    return (JaxImageNet(jax_args(args=args), is_training=is_training),
            ImageNetDataset(torch_args(args=args), is_training=is_training))


@pytest.mark.parametrize("extra", [
    [],
    ["--dataset.percentage-of-samples", "50"],
    ["--dataset.num-samples-per-category", "2"],
    ["--dataset.num-samples-per-category", "3", "--dataset.sample-selection-random-seed", "9"],
])
def test_dataset_finds_the_jax_classes_samples_and_subsets(folder, extra):
    ref, port = _datasets(folder, extra)
    assert port.classes == ref.classes == CLASSES
    assert port.samples == ref.samples
    assert port.share_dataset_arguments() == ref.share_dataset_arguments()
    if not extra:
        assert len(port) == 5 + 6 + 7 + 1  # the .txt file is not a sample
    val_ref, val_port = _datasets(folder, extra, is_training=False)
    assert val_port.samples == val_ref.samples and len(val_port) == 19  # no subset


def test_unreadable_image_reads_as_zeros_with_label_minus_one(folder):
    ref, port = _datasets(folder)
    idx = next(i for i, (p, _) in enumerate(port.samples) if p.endswith("img_9.jpg"))
    got, want = port[(32, 32, idx)], ref[(32, 32, idx)]
    assert got["targets"] == want["targets"] == -1 and got["sample_id"] == idx
    assert got["samples"].shape == (3, 32, 32) and not got["samples"].any()


def test_collate_replaces_corrupt_samples_as_jax():
    from cvnets_tpu.data.collate.collate_functions import default_collate_fn as jax_collate
    from cvnets_tpu_torch.data.collate.collate_functions import default_collate_fn

    rng = np.random.default_rng(1)
    items = [{"samples": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
              "targets": t, "sample_id": i} for i, t in enumerate([2, -1, 0, -1, -1])]
    want = jax_collate(items)
    got = default_collate_fn([{**it, "samples": torch.from_numpy(it["samples"]).permute(2, 0, 1)}
                              for it in items])
    assert got["targets"].tolist() == want["targets"].tolist() == [2, 0, 2, 0, 2]
    assert got["sample_id"].tolist() == want["sample_id"].tolist()
    assert got["targets"].dtype == got["sample_id"].dtype == torch.int64
    assert np.array_equal(got["samples"].permute(0, 2, 3, 1).numpy(), want["samples"])
    all_bad = default_collate_fn([{**items[1], "samples": torch.zeros(3, 4, 4)}] * 2)
    assert all_bad["targets"].tolist() == [-1, -1]  # left as it is, as in the JAX package


def _same_batches(port_loader, jax_loader, transforms_seed):
    random.seed(transforms_seed)
    ref = list(jax_loader)
    got = list(port_loader)
    assert len(got) == len(ref) == len(port_loader) > 0
    for b_port, b_ref in zip(got, ref):
        assert b_port["samples"].dtype == torch.uint8
        want = np.round(np.asarray(b_ref["samples"]) * 255.0).astype(np.int32)
        have = b_port["samples"].permute(0, 2, 3, 1).numpy().astype(np.int32)
        assert have.shape == want.shape
        assert np.abs(have - want).max() <= 1
        assert b_port["targets"].tolist() == np.asarray(b_ref["targets"]).tolist()
        assert b_port["sample_id"].tolist() == np.asarray(b_ref["sample_id"]).tolist()
    return got


@pytest.mark.parametrize("workers", [0, 3])
def test_loaders_give_the_jax_batches(folder, workers):
    from cvnets_tpu.data.data_loaders import create_test_loader as jax_test_loader
    from cvnets_tpu.data.data_loaders import create_train_val_loader as jax_loaders
    from cvnets_tpu_torch.data.data_loaders import create_test_loader, create_train_val_loader

    # the JAX loader's worker threads draw from the global ``random`` in the order they
    # run, so its batches are held with 0 workers, the port's with 0 and with 3
    opts_jax = jax_args(args=_args(folder, ["--dataset.workers", "0"]))
    opts_torch = torch_args(args=_args(folder, ["--dataset.workers", str(workers)]))
    jax_train, jax_val, jax_sampler = jax_loaders(opts_jax)
    jax_sampler.n_device_mult = jax_val.batch_sampler.n_device_mult = 1  # one card a process
    train, val, sampler = create_train_val_loader(opts_torch)
    assert train.num_workers == workers and not train.pin_memory
    assert getattr(opts_torch, "model.classification.n_classes") == 3
    corrupt_seen = False
    for epoch in range(2):
        jax_sampler.set_epoch(epoch)
        sampler.set_epoch(epoch)
        batches = _same_batches(train, jax_train, f"transforms:3:{epoch}")
        corrupt_seen |= any(not b["samples"].flatten(1).any(1).all() for b in batches)
    assert not corrupt_seen  # the unreadable sample never reaches a batch
    _same_batches(val, jax_val, 0)
    test_jax, test = jax_test_loader(opts_jax), create_test_loader(opts_torch)
    test_jax.batch_sampler.n_device_mult = 1
    batches = _same_batches(test, test_jax, 0)
    assert batches[0]["samples"].shape == (5, 3, 32, 32)


def test_a_worker_error_reaches_the_consumer():
    from cvnets_tpu_torch.data.loader.dataloader import CVNetsDataLoader

    class Broken:
        def __getitem__(self, t):
            raise OSError(f"cannot read {t}")

    loader = CVNetsDataLoader(Broken(), [[(8, 8, 0), (8, 8, 1)]], num_workers=2)
    with pytest.raises(OSError, match="cannot read"):
        list(loader)


def test_a_consumer_that_stops_early_ends_the_producer(folder):
    import threading

    from cvnets_tpu_torch.data.data_loaders import create_train_val_loader

    train, _, _ = create_train_val_loader(
        torch_args(args=_args(folder, ["--dataset.workers", "0"])))
    before = threading.active_count()
    for _ in train:
        break
    assert threading.active_count() <= before


def test_without_pillow_reading_an_image_raises_and_names_the_roadmap_item(folder, monkeypatch):
    import sys

    _, port = _datasets(folder)  # the folder walk needs no Pillow
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"needs Pillow, which is not installed"):
        port[(32, 32, 0)]
