"""The port's native JPEG path (``cvnets_tpu_torch.native``) against the JAX
package's ``cvnets_tpu/native/decode.cpp``, and its whole-batch route through
the dataset and the loader.

The JAX library is a private build: ``decode.cpp`` compiled with g++ and
libjpeg into this module's temporary directory, and ``cvnets_tpu.native``'s
module globals (``_SO``, ``_LIB``, ``_TRIED``) pointed at it for the module, so
nothing here races the JAX tests' in-place ``_decode.so`` build or edits a file
of the JAX package. The corpus: seeded smooth-and-grain images of 150-240 px
that Pillow writes at quality 90 as 4:2:0, 4:4:4 and grayscale JPEGs, plus
a file cut inside its header and a CMYK one.

* The plain version (Pillow's decode, then the kernel's steps in torch ops)
  against ``decode_rrc_batch`` of the JAX library, with and without the flip:
  - the library twice: as the JAX package builds it, where g++ contracts
    ``acc * inv + 0.5f`` and the bilinear blends into fused multiply-adds, and
    with ``-ffp-contract=off``, which rounds each operation as the port does;
  - whole images at prescale 1: the same bits as the uncontracted build (one
    libjpeg decode each side) and within 1 level of the JAX package's, where
    a fused multiply-add rounds a tie the other way (``CONTRACTION``);
  - crops at prescale 1 against the uncontracted build: 4:4:4 and grayscale
    the same bits; 4:2:0 too but along the crop's border, where decode.cpp's
    partial decode (``jpeg_crop_scanline``, ``jpeg_skip_scanlines``)
    upsamples the chroma as at the image's edge (``PRESCALE1_420``);
  - prescale 2, 4 and 8: decode.cpp asks libjpeg's scaled IDCT for the
    coarser raster, which nvJPEG has not, so the port takes the rounded box
    mean of the full raster instead (``native/plain.py``): the mean and max
    |diff| measured on this corpus (``PRESCALED``, by kind) hold it;
  - a file cut inside its header and a CMYK file fail in both (status 0,
    zeros); grayscale reads as RGB in both.
* ``crop_plan`` takes decode.cpp's crop clamp, prescale and 1.5× rule.
* The whole-batch route: ``fetch_batch_native`` on the CPU draws the boxes and
  flips that the ``pil`` route draws for one seed; a failed file's slot takes
  the valid ones in turn in place (targets and ids too), and targets are -1
  when none is valid (the JAX protocol); the loader routes an eligible batch
  native and any other one per sample; a run stopped after its first epoch
  resumes bit for bit with ``--dataset.decoder native``.
* The CUDA entry points' ctypes bindings against csrc/jpeg_decode.cu's C
  signatures; the kernel wrapper refusing a CPU tensor without counting.
* On a CUDA card only (``python -m pytest --noconftest -m cuda
  tests/test_torch_native_decode.py``): the crop → resize → flip kernel
  against the plain version on the same nvJPEG rasters at every crop class
  (prescale 1, 2, 4, 8; area and bilinear; flips), bit for bit, and the batch
  API against the plain resample of nvJPEG's rasters.

Tolerance of the kernel against the plain version: none. Both take the same
integer steps and the same float32 operations in the same order, each rounded
alone (the kernel spells them as ``_rn`` intrinsics, so nvcc fuses no
multiply-add), so the bits agree.
"""

from __future__ import annotations

import ctypes
import io
import os
import random
import re
import subprocess

import numpy as np
import pytest
import torch

from cvnets_tpu_torch import native
from cvnets_tpu_torch.native import plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "cvnets_tpu_torch", "csrc", "jpeg_decode.cu")
KINDS = ("420", "420", "444", "gray")
# prescale 1, 4:2:0 crops against decode.cpp without contraction: the share of
# values equal, the mean and max |diff| in levels (the crop's border rows and
# columns, see above); measured 0.9926, 0.0198 and 20 over both flips
PRESCALE1_420 = {"exact": 0.99, "mean": 0.025, "max": 20}
# whole images at prescale 1 against the JAX package's build: the share of
# values its fused multiply-adds leave equal (measured 0.999995; the rest 1 level)
CONTRACTION = 0.9999
# prescale 2, 4, 8 against the JAX package's build (the box mean against
# libjpeg's scaled IDCT), by kind: mean and max |diff| in levels, measured on
# this corpus over 30 seeded crops an image at 1.297 / 15, 0.376 / 6 and
# 0.143 / 1 (the largest over the three prescales)
PRESCALED = {"420": (1.30, 15), "444": (0.38, 6), "gray": (0.15, 1)}


def _image(rng, h: int, w: int) -> np.ndarray:
    from PIL import Image

    low = rng.integers(0, 256, (h // 12 + 2, w // 12 + 2, 3)).astype(np.uint8)
    field = np.asarray(Image.fromarray(low).resize((w, h), Image.BICUBIC), np.int16)
    return np.clip(field + rng.integers(-16, 17, (h, w, 3)), 0, 255).astype(np.uint8)


def _jpeg(arr: np.ndarray, kind: str) -> bytes:
    from PIL import Image

    img = Image.fromarray(arr)
    if kind == "gray":
        img = img.convert("L")
    elif kind == "cmyk":
        img = img.convert("CMYK")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90, subsampling=0 if kind == "444" else 2)
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus():
    """24 JPEGs (kinds in ``KINDS`` order) of 150-240 px, seeded."""
    rng = np.random.default_rng(0)
    blobs, kinds = [], []
    for k in range(24):
        kind = KINDS[k % len(KINDS)]
        blobs.append(_jpeg(_image(rng, int(rng.integers(150, 241)),
                                  int(rng.integers(150, 241))), kind))
        kinds.append(kind)
    return blobs, kinds


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """``cvnets_tpu.native`` on private builds of decode.cpp, with its libraries
    by name: "built" with the JAX package's own g++ flags (cvnets_tpu/native/
    __init__.py:28-33), under which g++ contracts ``a * b + c`` into fused
    multiply-adds on a CPU that has them, and "uncontracted" with
    ``-ffp-contract=off`` added, which rounds each operation as the port does."""
    import cvnets_tpu.native as jn

    libs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, extra in (("uncontracted", ["-ffp-contract=off"]), ("built", [])):
            so = str(tmp_path_factory.mktemp("decode") / "_decode.so")
            proc = subprocess.run(["g++", "-O3", "-march=native", *extra, "-shared", "-fPIC",
                                   "-std=c++17", jn._SRC, "-o", so, "-ljpeg", "-lpthread"],
                                  capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr[-2000:]
            mp.setattr(jn, "_SO", so)
            mp.setattr(jn, "_LIB", None)
            mp.setattr(jn, "_TRIED", False)
            libs[name] = jn.load_library()
            assert libs[name] is not None
        yield jn, libs


def _both(jax, blobs, crops, flips, out_hw, lib="built"):
    """(JAX batch by the library ``lib``, port batch) as (N, H, W, 3) int
    arrays, and both statuses."""
    jn, libs = jax
    jn._LIB = libs[lib]  # the module fixture's monkeypatch restores it
    ref, ok_ref = jn.decode_rrc_batch(blobs, crops, np.asarray(flips, np.uint8), out_hw)
    got, ok = native.decode_rrc_batch(blobs, crops, flips, out_hw, device="cpu")
    return (ref.astype(int), got.permute(0, 2, 3, 1).numpy().astype(int),
            ok_ref, ok)


def _random_crop(rng, w: int, h: int, out: int):
    cw, ch = int(rng.integers(out // 2, w + 1)), int(rng.integers(out // 2, h + 1))
    return (int(rng.integers(0, w - cw + 1)), int(rng.integers(0, h - ch + 1)), cw, ch)


@pytest.mark.parametrize("flip", [False, True])
def test_whole_images_at_prescale_1_are_the_same_bits(jax_native, corpus, flip):
    """The same bits as decode.cpp without contraction; within a level of the
    JAX package's build, whose fused ``acc * inv + 0.5f`` (and bilinear
    blends) round a tie the other way now and then (``CONTRACTION``)."""
    blobs, _ = corpus
    crops, flips = [(0, 0, -1, -1)] * len(blobs), [flip] * len(blobs)
    for b in blobs:
        w, h = plain.jpeg_size(b)
        assert plain.crop_plan(w, h, (0, 0, -1, -1), (128, 112))[0] == 1
    ref, got, ok_ref, ok = _both(jax_native, blobs, crops, flips, (128, 112), "uncontracted")
    assert ok_ref.all() and ok.all()
    assert np.array_equal(ref, got)
    ref, got, _, _ = _both(jax_native, blobs, crops, flips, (128, 112))
    d = np.abs(ref - got)
    assert d.max() <= 1 and (d == 0).mean() >= CONTRACTION


@pytest.mark.parametrize("flip", [False, True])
def test_crops_at_prescale_1_match_decode_cpp(jax_native, corpus, flip):
    blobs, kinds = corpus
    rng = np.random.default_rng(1 + flip)
    diffs = {"420": [], "444": [], "gray": []}
    for _ in range(12):
        crops, outs = [], []
        for b in blobs:
            w, h = plain.jpeg_size(b)
            out = int(rng.integers(48, 97))
            crop = _random_crop(rng, w, h, out)
            crop = (crop[0], crop[1], min(crop[2], 2 * out - 1), min(crop[3], 2 * out - 1))
            crops.append(crop)
            outs.append(out)
        for i, b in enumerate(blobs):  # one size a call, as a batch has
            ref, got, ok_ref, ok = _both(jax_native, [b], [crops[i]], [flip], (outs[i],) * 2,
                                         "uncontracted")
            assert plain.crop_plan(*plain.jpeg_size(b), crops[i], (outs[i],) * 2)[0] == 1
            assert ok_ref.all() and ok.all()
            diffs[kinds[i]].append(np.abs(ref - got).ravel())
    for kind in ("444", "gray"):
        assert np.concatenate(diffs[kind]).max() == 0, kind
    d420 = np.concatenate(diffs["420"])
    assert (d420 == 0).mean() >= PRESCALE1_420["exact"]
    assert d420.mean() <= PRESCALE1_420["mean"] and d420.max() <= PRESCALE1_420["max"]


@pytest.mark.parametrize("denom", [2, 4, 8])
def test_prescaled_crops_stay_within_the_measured_box_mean_difference(jax_native, corpus,
                                                                      denom):
    blobs, kinds = corpus
    rng = np.random.default_rng(10 + denom)
    diffs = {"420": [], "444": [], "gray": []}
    n = 0
    for trial in range(30):
        for i, b in enumerate(blobs):
            w, h = plain.jpeg_size(b)
            out = int(rng.integers(8, 64))
            crop = (0, 0, -1, -1) if trial == 0 else _random_crop(rng, w, h, out)
            if plain.crop_plan(w, h, crop, (out, out))[0] != denom:
                continue
            ref, got, ok_ref, ok = _both(jax_native, [b], [crop], [trial % 2 == 1],
                                         (out, out))
            assert ok_ref.all() and ok.all()
            diffs[kinds[i]].append(np.abs(ref - got).ravel())
            n += 1
    assert n >= 20
    for kind, (mean, worst) in PRESCALED.items():
        d = np.concatenate(diffs[kind])
        assert d.mean() <= mean and d.max() <= worst, (kind, d.mean(), d.max())


def test_failed_files_and_grayscale_match_decode_cpp(jax_native, corpus):
    blobs, kinds = corpus
    rng = np.random.default_rng(3)
    cmyk = _jpeg(_image(rng, 160, 200), "cmyk")
    cut = blobs[0][:100]  # before the frame header
    gray = [b for b, k in zip(blobs, kinds) if k == "gray"]
    batch = [gray[0], cut, cmyk, gray[1]]
    ref, got, ok_ref, ok = _both(jax_native, batch, [(0, 0, -1, -1)] * 4, [False] * 4,
                                 (150, 150), "uncontracted")
    assert ok_ref.tolist() == ok.tolist() == [True, False, False, True]
    assert not ref[1:3].any() and not got[1:3].any()
    assert np.array_equal(ref, got)  # grayscale as RGB, prescale 1: the same bits
    assert (got[0][..., 0] == got[0][..., 2]).all()
    assert native.jpeg_dimensions(cut, device="cpu") is None
    assert native.jpeg_dimensions(gray[0], device="cpu") == plain.jpeg_size(gray[0])
    dims = native.jpeg_dimensions_batch(batch, device="cpu")
    want = jax_native[0].jpeg_dimensions_batch(batch)
    assert np.array_equal(dims[[0, 1, 3]], want[[0, 1, 3]])


@pytest.mark.parametrize("size,crop,out", [
    ((500, 375), (0, 0, -1, -1), (224, 224)), ((500, 375), (10, 20, 300, 200), (96, 96)),
    ((500, 375), (499, 374, 50, 50), (32, 32)), ((3000, 2000), (0, 0, -1, -1), (100, 100)),
    ((500, 375), (-5, -9, 1000, 1000), (40, 60)), ((33, 17), (0, 0, 0, 5), (8, 8)),
])
def test_crop_plan_follows_decode_cpp(size, crop, out):
    """decode.cpp:138-172 and :201, written out here in its own words."""
    W, H = size
    cx, cy, cw, ch = crop
    if cw <= 0 or ch <= 0:
        cx, cy, cw, ch = 0, 0, W, H
    cx, cy = max(0, min(cx, W - 1)), max(0, min(cy, H - 1))
    cw, ch = max(1, min(cw, W - cx)), max(1, min(ch, H - cy))
    denom = 1
    while denom < 8 and cw // (denom * 2) >= out[1] and ch // (denom * 2) >= out[0]:
        denom *= 2
    dw, dh = (W + denom - 1) // denom, (H + denom - 1) // denom
    x, y = min(cx // denom, dw - 1), min(cy // denom, dh - 1)
    w, h = min(max(1, cw // denom), dw - x), min(max(1, ch // denom), dh - y)
    area = w >= out[1] * 3 // 2 and h >= out[0] * 3 // 2
    assert plain.crop_plan(W, H, crop, out) == (denom, x, y, w, h, area)


# ---- the whole-batch route ----------------------------------------------------

CLASSES = ("n01", "n02", "n03")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """An ImageFolder of 3 classes × 6 JPEGs (two kinds), the fourth file of
    n02 cut inside its header."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(5)
    for c, name in enumerate(CLASSES):
        (root / name).mkdir()
        for i in range(6):
            data = _jpeg(_image(rng, int(rng.integers(60, 100)), int(rng.integers(60, 100))),
                         "444" if i % 3 == 2 else "420")
            if name == "n02" and i == 3:
                data = data[:100]
            (root / name / f"img_{i}.jpg").write_bytes(data)
    return str(root)


def _opts(folder, decoder="native", extra=()):
    from cvnets_tpu_torch.options.opts import get_training_arguments

    return get_training_arguments(args=[
        "--dataset.name", "imagenet", "--dataset.category", "classification",
        "--dataset.root-train", folder, "--dataset.root-val", folder,
        "--dataset.decoder", decoder, "--dataset.train-batch-size0", "6",
        "--dataset.workers", "0", "--sampler.bs.crop-size-width", "32",
        "--sampler.bs.crop-size-height", "32",
        "--image-augmentation.random-resized-crop.enable",
        "--image-augmentation.random-horizontal-flip.enable", *extra])


def _dataset(folder, decoder="native"):
    from cvnets_tpu_torch.data.datasets.classification.imagenet import ImageNetDataset

    return ImageNetDataset(_opts(folder, decoder), is_training=True)


def test_native_route_draws_the_boxes_and_flips_of_the_pil_route(folder, monkeypatch):
    ds = _dataset(folder)
    tuples = [(32, 40, i) for i in range(len(ds))]
    pil = [ds.draw_params(t, r) for r in [random.Random(7)] for t in tuples]
    seen = {}

    def record(blobs, crops, flips, out_hw, device, decoder=None):
        seen.update(crops=list(crops), flips=list(flips), out_hw=out_hw)
        return plain.decode_rrc_batch_plain(blobs, crops, flips, out_hw)

    monkeypatch.setattr(native, "decode_rrc_batch", record)
    batch = ds.fetch_batch_native(tuples, random.Random(7), "cpu")
    assert seen["out_hw"] == (32, 40) and tuple(batch["samples"].shape) == (18, 3, 32, 40)
    for p, crop, flip in zip(pil, seen["crops"], seen["flips"]):
        if p is None:  # the file cut inside its header: no draw on either route
            assert crop == (0, 0, -1, -1) and not flip
            continue
        (top, left, h, w), want_flip = p[0], p[1]
        assert crop == (left, top, w, h) and flip == want_flip
    assert sum(p is None for p in pil) == 1


def test_crops_of_the_output_size_are_the_decoded_pixels(folder):
    """Crops that need no resampling (the output is the crop's size, so the
    bilinear taps land on its pixels) give the pil route's pixels exactly."""
    ds = _dataset(folder)
    blobs = [ds._read_bytes(i) for i in range(3)]
    crops = [(3, 5, 40, 32), (0, 0, 40, 32), (7, 2, 40, 32)]
    got, ok = native.decode_rrc_batch(blobs, crops, [False, True, False], (32, 40), "cpu")
    assert ok.all()
    for i, (x, y, w, h) in enumerate(crops):
        rgb = torch.from_numpy(plain.decode_rgb(blobs[i])).permute(2, 0, 1)[:, y:y + h,
                                                                           x:x + w]
        assert torch.equal(got[i], rgb.flip(-1) if i == 1 else rgb)


def test_failed_slots_take_valid_ones_in_place(folder, monkeypatch):
    ds = _dataset(folder)
    bad = [i for i, (p, _) in enumerate(ds.samples) if p.endswith(os.path.join("n02", "img_3.jpg"))]
    good = [i for i in range(len(ds)) if i not in bad]
    idxs = [good[0], bad[0], good[1], bad[0], good[2]]
    batch = ds.fetch_batch_native([(32, 32, i) for i in idxs], random.Random(0), "cpu")
    ids, targets = batch["sample_id"].tolist(), batch["targets"].tolist()
    assert ids == [good[0], good[0], good[1], good[1], good[2]]  # valid ones in turn
    assert targets == [ds.samples[i][1] for i in ids]
    assert torch.equal(batch["samples"][1], batch["samples"][0])
    assert torch.equal(batch["samples"][3], batch["samples"][2])
    none = ds.fetch_batch_native([(32, 32, bad[0])] * 2, random.Random(0), "cpu")
    assert none["targets"].tolist() == [-1, -1] and not none["samples"].any()


def test_eligibility_follows_the_jax_dataset(folder):
    from cvnets_tpu_torch.data.datasets.classification.imagenet import ImageNetDataset

    assert _dataset(folder)._native_batch_eligible([(32, 32, 0)])
    assert not _dataset(folder, "pil")._native_batch_eligible([(32, 32, 0)])
    assert not ImageNetDataset(_opts(folder), is_training=False)._native_batch_eligible()
    no_rrc = _opts(folder)
    setattr(no_rrc, "image_augmentation.random_resized_crop.enable", False)
    assert not ImageNetDataset(no_rrc, is_training=True)._native_batch_eligible()
    ds = _dataset(folder)
    ds.samples = ds.samples[:1] + [("x.png", 0)]
    assert ds._native_batch_eligible([(32, 32, 0)])
    assert not ds._native_batch_eligible([(32, 32, 0), (32, 32, 1)])


def test_loader_routes_eligible_batches_native_and_others_per_sample(folder, monkeypatch):
    from cvnets_tpu_torch.data.data_loaders import create_train_val_loader

    calls = {"native": 0}
    loader, _, sampler = create_train_val_loader(_opts(folder), device="cpu")
    fetch = loader.dataset.fetch_batch_native

    def counted(*a, **k):
        calls["native"] += 1
        return fetch(*a, **k)

    monkeypatch.setattr(loader.dataset, "fetch_batch_native", counted)
    batches = list(loader)
    assert calls["native"] == len(batches) == len(sampler) == 3
    for b in batches:
        assert b["samples"].dtype == torch.uint8 and tuple(b["samples"].shape[1:]) == (3, 32, 32)
    pil_loader, _, _ = create_train_val_loader(_opts(folder, "pil"), device="cpu")
    assert not any(pil_loader._native(t) for t in pil_loader.batch_sampler)


def _train(folder, results, max_epochs=None):
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer

    built = []

    class Stopped(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if max_epochs is not None:
                self.max_epochs = max_epochs
            built.append(self)

    args = ["--dataset.name", "imagenet", "--dataset.category", "classification",
            "--dataset.root-train", folder, "--dataset.root-val", folder,
            "--dataset.decoder", "native", "--dataset.train-batch-size0", "6",
            "--dataset.val-batch-size0", "6", "--dataset.workers", "2",
            "--sampler.bs.crop-size-width", "32", "--sampler.bs.crop-size-height", "32",
            "--image-augmentation.random-resized-crop.enable",
            "--image-augmentation.random-horizontal-flip.enable",
            "--image-augmentation.center-crop.enable",
            "--image-augmentation.center-crop.size", "32",
            "--model.classification.name", "vit", "--model.classification.vit.mode", "micro",
            "--model.activation.name", "gelu", "--optim.name", "adamw", "--ema.enable",
            "--scheduler.max-epochs", "2", "--common.auto-resume",
            "--common.results-loc", str(results)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(main_train, "Trainer", Stopped)
        main_train.main_worker(args=args, device="cpu")
    return built[-1]


def test_a_native_run_stopped_after_its_first_epoch_resumes_bit_identical(folder, tmp_path):
    whole = _train(folder, tmp_path / "whole")
    first = _train(folder, tmp_path / "split", max_epochs=1)
    assert first.train_iterations == 3
    resumed = _train(folder, tmp_path / "split")
    assert (resumed.start_epoch, resumed.state.step) == (1, whole.state.step) == (1, 6)
    for a, b in ((whole.model, resumed.model), (whole.state.ema.model, resumed.state.ema.model)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), key


# ---- the CUDA entry points ------------------------------------------------------

def _c_params(symbol: str) -> list:
    src = open(CSRC).read()
    params = re.search(rf'\n(?:int|void) {symbol}\((.*?)\)\s*\{{', src, re.S).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "void**": ctypes.c_void_p,
             "const unsigned char* const*": ctypes.c_void_p, "const size_t*": ctypes.c_void_p,
             "int*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
             "unsigned char*": ctypes.c_void_p, "const long long*": ctypes.c_void_p,
             "const void*": ctypes.c_void_p}
    return [kinds[re.sub(r"\s*\w+$", "", p.strip())] for p in params.split(",")]


@pytest.mark.parametrize("symbol", ["jd_create", "jd_destroy", "jd_info", "jd_decode"])
def test_decoder_bindings_match_the_c_entry_points(symbol):
    argtypes = native._BINDINGS[symbol][0]
    want = _c_params(symbol)
    assert len(argtypes) == len(want)
    assert all(a is w or (a is not ctypes.c_int and w is ctypes.c_void_p)
               for a, w in zip(argtypes, want))


def test_raster_layout_and_kernel_params():
    """Rasters packed back to back (3 bytes a pixel, 1 for grayscale, none for
    a file nvJPEG cannot decode) and the kernel's rows of params."""
    info = np.array([[4, 3, 3], [5, 2, 1], [0, 0, 0], [2, 2, 4], [3, 1, 3]], np.int32)
    offsets, total = native.raster_layout(info)
    assert offsets.tolist() == [0, 36, 46, 46, 46] and total == 55
    params = native.kernel_params(info, offsets, [(1, 2, 3, 4)] * 5,
                                  [True, False, True, False, True], np.array([1, 1, 0, 0, 1]))
    assert params.dtype == np.int64 and params.shape == (5, native.N_PARAMS)
    assert params[1].tolist() == [36, 5, 2, 1, 1, 2, 3, 4, 0, 1]
    assert params[:, 3].tolist() == [3, 1, 3, 3, 3] and params[:, 9].tolist() == [1, 1, 0, 0, 1]


def test_kernel_binding_matches_the_c_entry_point_and_refuses_cpu_tensors():
    kernel = native.crop_resize_flip_kernel
    assert kernel._argtypes == _c_params("crop_resize_flip")
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        native.crop_resize_flip(torch.zeros(16, dtype=torch.uint8),
                                torch.zeros((1, native.N_PARAMS), dtype=torch.int64), (8, 8))
    assert kernel.launches == before


# ---- on a CUDA card ------------------------------------------------------------

CLASS_CASES = [(1, True, 64, 100, 105), (1, False, 96, 120, 110), (2, True, 40, 130, 140),
               (2, False, 40, 85, 140), (4, True, 20, 140, 150), (4, False, 20, 85, 150),
               (8, True, 8, 140, 150), (8, False, 8, 68, 150)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLASS_CASES, ids=lambda c: f"prescale{c[0]}-{'area' if c[1] else 'bilinear'}")
def test_kernel_matches_plain_on_cuda(corpus, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (nvJPEG and the kernel have no CPU mode)")
    blobs, _ = corpus
    denom, area, out, cw, ch = case
    device = torch.device("cuda", torch.cuda.current_device())
    decoder = native.JpegDecoder(device)
    info = decoder.info(blobs)
    offsets, total = native.raster_layout(info)
    raster, status = decoder.decode(blobs, info, offsets, total)
    chans = np.where(info[:, 2] == 1, 1, 3)
    assert status.all()
    rng = random.Random(denom)
    crops = [(rng.randint(0, int(w) - cw), rng.randint(0, int(h) - ch), cw, ch)
             for w, h, _ in info]
    for (w, h, _), crop in zip(info, crops):
        plan = plain.crop_plan(int(w), int(h), crop, (out, out))
        assert (plan[0], plan[5]) == (denom, area)
    for flip in (False, True):
        params = native.kernel_params(info, offsets, crops, [flip] * len(blobs), status)
        before = native.crop_resize_flip_kernel.launches
        got = native.crop_resize_flip(raster, torch.from_numpy(params), (out, out))
        assert native.crop_resize_flip_kernel.launches == before + 1
        for i, ((w, h, _), off, c) in enumerate(zip(info, offsets, chans)):
            view = raster[off:off + int(w * h * c)].view(int(h), int(w), int(c))
            want = plain.crop_resize_flip(view.expand(-1, -1, 3), crops[i], flip, (out, out))
            assert torch.equal(got[i], want), (i, flip)
    decoder.close()


@pytest.mark.cuda
def test_batch_api_on_cuda_decodes_to_the_card_and_fails_a_cut_file(corpus):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (nvJPEG and the kernel have no CPU mode)")
    blobs, _ = corpus
    batch = blobs[:5] + [blobs[0][:100]]
    crops = [(0, 0, -1, -1)] * len(batch)
    got, ok = native.decode_rrc_batch(batch, crops, [True] * len(batch), (64, 64))
    assert got.is_cuda and got.dtype == torch.uint8 and tuple(got.shape) == (6, 3, 64, 64)
    assert ok.tolist() == [True] * 5 + [False]
    assert not got[5].any()
    assert native.jpeg_dimensions(batch[5]) is None
    assert native.jpeg_dimensions(blobs[1]) == plain.jpeg_size(blobs[1])
