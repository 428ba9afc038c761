"""The port's offline segmentation evaluation against the JAX package's
(cvnets_tpu/engine/eval_segmentation.py), with the same weights: a micro
DeepLabv3 (MobileNetV2-0.25, ASPP 32, 150 classes) filled from one flax tree.

* ``predict_labeled_dataset`` over a tiny ADE20k validation folder that Pillow
  writes (images at the crop's 64², so neither package resamples them; masks
  with raw 0 read as the ignore label) gives JAX's mIoU;
* ``main_worker_segmentation`` in the ``image_folder`` and ``single_image``
  modes, on a checkpoint of those weights, writes the label PNGs (raw and in
  the colour palette) that JAX's ``predict_and_save`` writes for the same
  files (read and resized to the eval size by Pillow in both), and the
  overlay where asked.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    blob_mask,
    both_opts,
    perturbed_variables,
    port_model_from,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """torch on two threads: the suite's xdist workers share the cores."""
    from torch_port_helpers import torch_threads

    with torch_threads(2):
        yield


EVAL_ARGS = [
    "--dataset.category", "segmentation",
    "--dataset.name", "ade20k",
    "--dataset.workers", "0",
    "--dataset.eval-batch-size0", "2",
    "--dataset.decoder", "pil",
    "--sampler.bs.crop-size-width", "64",
    "--sampler.bs.crop-size-height", "64",
    "--model.segmentation.name", "encoder_decoder",
    "--model.segmentation.n-classes", "150",
    "--model.segmentation.seg-head", "deeplabv3",
    "--model.segmentation.output-stride", "16",
    "--model.segmentation.deeplabv3.aspp-out-channels", "32",
    "--model.classification.name", "mobilenetv2",
    "--model.classification.mobilenetv2.width-multiplier", "0.25",
    "--model.activation.name", "relu",
    "--loss.category", "segmentation",
]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from PIL import Image

    from cvnets_tpu.models import get_model

    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    os.makedirs(root / "ade/images/validation")
    os.makedirs(root / "ade/annotations/validation")
    os.makedirs(root / "folder")
    for name, (h, w) in (("p", (50, 70)), ("q", (80, 48))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / f"folder/{name}.png")
    args = EVAL_ARGS + ["--dataset.root-val", str(root / "ade")]
    jax_opts, opts = both_opts(args)
    jmodel = get_model(jax_opts)
    variables = perturbed_variables(jmodel, np.zeros((1, 64, 64, 3), np.float32))
    model = port_model_from(opts, variables).eval()
    images = []
    for i in range(5):  # the images as the readers decode them
        path = root / f"ade/images/validation/{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)).save(path)
        images.append(np.asarray(Image.open(path).convert("RGB")))
    images = np.stack(images)
    with torch.no_grad():  # masks that agree with the model in some blobs: an mIoU > 0
        pred = model(torch.from_numpy(images).permute(0, 3, 1, 2) / 255.0).argmax(1).numpy()
    for i in range(len(images)):
        raw = np.where(blob_mask(rng, 64, 64, 2) == 1, pred[i] + 1,
                       blob_mask(rng, 64, 64, 151)).astype(np.uint8)
        Image.fromarray(raw).save(root / f"ade/annotations/validation/{i}.png")
    ckpt = str(root / "checkpoint.pt")
    torch.save(model.state_dict(), ckpt)
    return dict(root=root, args=args, jax_opts=jax_opts, opts=opts, jmodel=jmodel,
                variables=variables, model=model, ckpt=ckpt)


def test_validation_set_miou_matches_jax(setup):
    from cvnets_tpu.data.data_loaders import create_test_loader as jax_loader
    from cvnets_tpu.engine.eval_segmentation import predict_labeled_dataset as jax_miou
    from cvnets_tpu_torch.data.data_loaders import create_test_loader
    from cvnets_tpu_torch.engine.eval_segmentation import predict_labeled_dataset

    jax_opts, opts = setup["jax_opts"], setup["opts"]
    loader = jax_loader(jax_opts)
    want = jax_miou(jax_opts, setup["jmodel"], setup["variables"], loader)
    # the JAX batch is the flag's times the devices of tests/conftest.py's mesh; a
    # last batch is padded with repeats, which count in both: take the same batch
    setattr(opts, "dataset.eval_batch_size0", len(next(iter(loader.batch_sampler))))
    got = predict_labeled_dataset(opts, setup["model"], create_test_loader(opts), "cpu")
    assert 0.0 < want < 100.0
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("mode", ["image_folder", "single_image"])
def test_prediction_files_match_jax(setup, mode, tmp_path):
    from PIL import Image

    from cvnets_tpu.engine.eval_segmentation import (
        _eval_size,
        _load_image_f32,
        predict_and_save,
    )
    from cvnets_tpu_torch.main_eval import main_worker_segmentation

    flags = ["--evaluation.segmentation.save-masks", "--evaluation.segmentation.apply-color-map",
             "--evaluation.segmentation.save-overlay-rgb-pred",
             "--evaluation.segmentation.resize-input-images-fixed-size", "48", "56"]
    folder = setup["root"] / "folder"
    path = str(folder if mode == "image_folder" else folder / "q.png")
    jax_opts, _ = both_opts(setup["args"] + flags)
    jax_dir = tmp_path / "jax"
    files = sorted(os.listdir(folder)) if mode == "image_folder" else ["q.png"]
    for name in files:
        image = _load_image_f32(str(folder / name), _eval_size(jax_opts))
        predict_and_save(jax_opts, setup["jmodel"], setup["variables"], image,
                         out_dir=str(jax_dir), fname=os.path.splitext(name)[0])
    out = main_worker_segmentation(args=setup["args"] + flags + [
        "--evaluation.segmentation.mode", mode, "--evaluation.segmentation.path", path,
        "--model.segmentation.pretrained", setup["ckpt"],
        "--common.results-loc", str(tmp_path / "port")], device="cpu")
    assert out == str(tmp_path / "port" / "predictions")
    written = sorted(os.listdir(out))
    assert written == sorted(os.listdir(jax_dir))
    assert len(written) == 3 * len(files)
    for name in written:
        got, want = Image.open(os.path.join(out, name)), Image.open(jax_dir / name)
        assert got.mode == want.mode and got.size == want.size == (56, 48), name
        if name.endswith(".png"):  # labels, raw and in the palette
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)
            assert got.getpalette() == want.getpalette()


def test_validation_set_miou_normalizes_as_the_evaluator_and_jax(setup):
    """Under ``--image-augmentation.to-tensor.mean-std-normalization.enable``
    the offline mIoU scores the inputs the Evaluator scores (the JAX
    ``ToFloatTensor`` normalizes every loader's samples), not [0, 1] ones.
    The offline mIoU counts the repeats that fill JAX's batch of 16 as JAX
    does; the Evaluator counts each of the 5 samples once, as the offline
    mIoU does over one batch of the 5."""
    from cvnets_tpu.data.data_loaders import create_test_loader as jax_loader
    from cvnets_tpu.engine.eval_segmentation import predict_labeled_dataset as jax_miou
    from cvnets_tpu_torch.data.data_loaders import create_test_loader
    from cvnets_tpu_torch.engine import Evaluator
    from cvnets_tpu_torch.engine.eval_segmentation import predict_labeled_dataset

    flag = ["--image-augmentation.to-tensor.mean-std-normalization.enable",
            "--stats.val", "iou"]
    jax_opts, opts = both_opts(setup["args"] + flag)
    loader = jax_loader(jax_opts)
    want = jax_miou(jax_opts, setup["jmodel"], setup["variables"], loader)
    setattr(opts, "dataset.eval_batch_size0", len(next(iter(loader.batch_sampler))))
    got = predict_labeled_dataset(opts, setup["model"], create_test_loader(opts), "cpu")
    stats = Evaluator(opts, setup["model"], create_test_loader(opts), device="cpu").eval_fn_image()
    setattr(opts, "dataset.eval_batch_size0", 5)  # the set in one batch: no repeat
    once = predict_labeled_dataset(opts, setup["model"], create_test_loader(opts), "cpu")
    unnormalized = predict_labeled_dataset(setup["opts"], setup["model"],
                                           create_test_loader(setup["opts"]), "cpu")
    assert got == pytest.approx(want, rel=1e-12)
    assert once == pytest.approx(stats["iou"], rel=1e-9)
    assert got != unnormalized  # the flag changes what the model sees
