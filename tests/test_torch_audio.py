"""Audio and the ByteFormer entry points of the port against the JAX package,
on the CPU:

* the wav writer at every ``encoding_dtype`` (mono and stereo), byte for byte
  against JAX's; mp3 fails in both; ``standardize_channels``;
* the clip transforms (fixed length, ambient noise from files, roll) with the
  draws JAX makes from the global ``random`` after ``random.seed``;
* Speech Commands v2 on a seeded folder: the splits, the bytes mode (Pinned
  3: ``as-bytes`` cannot be turned off, and the ``float32`` yaml trains on the
  file's own int16 bytes, ``torchaudio_save`` skipping them), the waveform
  route with mixup (JAX's draws injected), the transforms no yaml sets
  refusing, naming their item;
* ``main_train`` for one epoch on a micro copy of byteformer.yaml (a JPEG
  folder) and of byteformer_wav.yaml (a Speech Commands folder), and a run
  stopped after its first epoch resuming bit for bit.
"""

from __future__ import annotations

import math
import os
import random
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAV_YAML = os.path.join(REPO, "config/audio_classification/speech_commands/byteformer_wav.yaml")
JPEG_YAML = os.path.join(REPO, "config/classification/imagenet/byteformer.yaml")
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import both_opts, torch_threads  # noqa: E402

WORDS = ["bed", "bird", "cat", "dog"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def speech_folder(tmp_path_factory):
    """4 words × (3 train + 1 validation + 1 test) clips, a noise folder."""
    import wave

    from cvnets_tpu_torch.tools.speech_commands_corpus import clip, write_speech_commands

    root = tmp_path_factory.mktemp("speech_commands")
    write_speech_commands(str(root), 4, 1, words=WORDS)
    with open(root / "testing_list.txt", "w") as f:
        f.write("".join(f"{w}/0000_nohash_3.wav\n" for w in WORDS))
    noise = root / "_background_noise_"
    noise.mkdir()
    for k, n in enumerate((24000, 9000, 16000)):  # longer and shorter than a clip
        with wave.open(str(noise / f"noise_{k}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(clip(34, 100 + k, n=n).tobytes())
    return str(root)


# ------------------------------------------------------------- wav bytes

@pytest.mark.parametrize("dtype", ["float32", "int32", "int16", "uint8"])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_writer_gives_jax_bytes(dtype, channels):
    from cvnets_tpu.data.transforms.audio_bytes import TorchaudioSave as JaxSave
    from cvnets_tpu_torch.data.transforms.audio_bytes import TorchaudioSave

    args = ["--audio-augmentation.torchaudio-save.enable",
            "--audio-augmentation.torchaudio-save.encoding-dtype", dtype]
    opts_jax, opts = both_opts(args)
    rng = np.random.default_rng(channels)
    x = np.clip(rng.standard_normal((channels, 1001)) * 0.4, -1, 1).astype(np.float32)
    x[0, :3] = (-1.0, 1.0, 0.0)  # the ends of the range
    if channels == 1:
        x = x[0]
    for fps in (16000, 8000):
        want = JaxSave(opts_jax)({"samples": {"audio": x.copy()},
                                  "metadata": {"audio_fps": fps}})["samples"]["audio"]
        got = TorchaudioSave(opts)({"samples": {"audio": x.copy()},
                                    "metadata": {"audio_fps": fps}})["samples"]["audio"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert bytes(got[:4].astype(np.uint8)) == b"RIFF"


def test_mp3_fails_as_in_jax():
    from cvnets_tpu.data.transforms.audio_bytes import TorchaudioSave as JaxSave
    from cvnets_tpu_torch.data.transforms.audio_bytes import TorchaudioSave
    from cvnets_tpu_torch.utils.logger import LoggerError

    opts_jax, opts = both_opts(["--audio-augmentation.torchaudio-save.format", "mp3"])
    item = {"samples": {"audio": np.zeros(100, np.float32)}}
    with pytest.raises(BaseException):
        JaxSave(opts_jax)(item)
    with pytest.raises(LoggerError, match="mp3"):
        TorchaudioSave(opts)(item)


@pytest.mark.parametrize("channels,want", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_standardize_channels_matches_jax(channels, want):
    from cvnets_tpu.data.transforms.audio_bytes import StandardizeChannels as Jax
    from cvnets_tpu_torch.data.transforms.audio_bytes import StandardizeChannels

    opts_jax, opts = both_opts(["--audio-augmentation.standardize-channels.enable",
                                "--audio-augmentation.standardize-channels.num-channels",
                                str(want)])
    x = np.random.default_rng(0).standard_normal((2, 50, channels)).astype(np.float32)
    a = Jax(opts_jax)({"samples": {"audio": x.copy()}})["samples"]["audio"]
    b = StandardizeChannels(opts)({"samples": {"audio": x.copy()}})["samples"]["audio"]
    assert b.shape == (2, 50, want)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- the dataset

AUDIO_ARGS = ["--dataset.category", "audio_classification",
              "--dataset.name", "speech_commands_v2",
              "--audio-augmentation.set-fixed-length.enable",
              "--audio-augmentation.set-fixed-length.length", "12000"]


def _datasets(root, extra=(), is_training=True, is_evaluation=False, waveform=False):
    from cvnets_tpu.data.datasets.audio_classification.speech_commands_v2 import (
        SpeechCommandsV2 as JaxDS,
    )
    from cvnets_tpu_torch.data.datasets.audio_classification.speech_commands_v2 import (
        SpeechCommandsV2,
    )

    opts_jax, opts = both_opts(AUDIO_ARGS + ["--dataset.root-train", root,
                                             "--dataset.root-val", root, *extra])
    if waveform:  # as the JAX tests do: no flag turns it off
        for o in (opts_jax, opts):
            setattr(o, "dataset.speech_commands.as_bytes", False)
    random.seed(0)  # the noise files JAX picks at construction; the port's own seed 0
    kw = dict(is_training=is_training, is_evaluation=is_evaluation)
    return JaxDS(opts_jax, **kw), SpeechCommandsV2(opts, **kw)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataset_splits_and_bytes_equal_jax(speech_folder, split):
    jax_ds, ds = _datasets(speech_folder, is_training=split == "train",
                           is_evaluation=split == "test")
    assert ds.samples == jax_ds.samples
    assert len(ds) == {"train": 12, "val": 4, "test": 4}[split]
    assert ds.share_dataset_arguments() == {"model.classification.n_classes": 35}
    for i in range(len(ds)):
        want, got = jax_ds[i], ds[i]
        np.testing.assert_array_equal(got["samples"], want["samples"])
        assert got["targets"] == want["targets"] and got["samples"].dtype == np.int32
        with open(ds.samples[i][0], "rb") as f:  # the file's own bytes
            assert bytes(got["samples"].astype(np.uint8)) == f.read()


def test_as_bytes_cannot_be_turned_off_and_the_float32_yaml_trains_on_file_bytes(
        speech_folder):
    """Pinned 3: the flag is ``store_true`` with default True, and
    ``torchaudio_save`` (``encoding_dtype: float32``) skips an integer sample,
    so the batch holds the files' int16 wav bytes, as in JAX."""
    from cvnets_tpu.data.collate.byteformer_collate_functions import (
        byteformer_audio_collate_fn as jax_collate,
    )
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.data.collate.byteformer_collate_functions import (
        byteformer_audio_collate_fn,
    )
    from cvnets_tpu_torch.data.datasets import build_dataset_from_registry
    from cvnets_tpu_torch.options.opts import get_training_arguments

    yaml = os.path.join(REPO, "examples/byteformer/speech_commands_wav/"
                              "encoding_dtype_float32_k16.yaml")
    args = ["--common.config-file", yaml, "--common.override-kwargs",
            f"dataset.root_train={speech_folder}", f"dataset.root_val={speech_folder}"]
    opts = get_training_arguments(args=args)
    assert getattr(opts, "dataset.speech_commands.as_bytes")
    assert getattr(opts, "audio_augmentation.torchaudio_save.encoding_dtype") == "float32"
    ds = build_dataset_from_registry(opts)
    items = [ds[i] for i in range(4)]
    got = byteformer_audio_collate_fn(items, opts, rng=random.Random(0))
    want = jax_collate([dict(it) for it in items], jax_args(args=args))
    np.testing.assert_array_equal(got["samples"].numpy(), want["samples"])
    for row, (path, _) in zip(got["samples"].numpy(), ds.samples[:4]):
        with open(path, "rb") as f:
            data = f.read()
        assert bytes(row[:len(data)].astype(np.uint8)) == data and (row[len(data):] == -1).all()
        assert data[20:22] == b"\x01\x00" and data[34:36] == b"\x10\x00"  # PCM, 16 bits


def test_waveform_route_with_noise_and_roll_draws_what_jax_draws(speech_folder):
    extra = ["--audio-augmentation.noise.enable", "--audio-augmentation.noise.levels",
             "-20", "-10", "--audio-augmentation.roll.enable"]
    jax_ds, ds = _datasets(speech_folder, extra, waveform=True)
    assert [w.shape for w, _ in ds._transforms[1].noise_waves] == \
        [w.shape for w, _ in jax_ds._transforms[1].noise_waves]
    for i in (0, 5, 11):
        random.seed(i)
        want = jax_ds[i]
        got = ds.get_item(i, ds.draw_params(i, random.Random(i)))
        assert got["samples"].shape == (12000,) and got["targets"] == want["targets"]
        np.testing.assert_array_equal(got["samples"], want["samples"])


def test_waveform_mixup_matches_jax_with_its_draws_injected(speech_folder):
    """JAX draws the roll from ``random`` and the partner and weight from
    ``np.random``: replayed here and handed to ``get_item``."""
    extra = ["--audio-augmentation.roll.enable", "--dataset.speech-commands-v2.mixup"]
    jax_ds, ds = _datasets(speech_folder, extra, waveform=True)
    window = int(12000 * 0.1)
    for i in (1, 7):
        random.seed(i)
        np.random.seed(i)
        want = jax_ds[i]
        r, npr = random.Random(i), np.random.RandomState(i)
        own = [None, r.randint(-window, window)]
        other = int(npr.randint(0, len(ds)))
        params = (own, (other, [None, r.randint(-window, window)], float(npr.rand())))
        got = ds.get_item(i, params)
        np.testing.assert_allclose(got["samples"], want["samples"], rtol=0, atol=1e-7)
        np.testing.assert_allclose(got["targets"], want["targets"], rtol=0, atol=1e-7)
        assert got["targets"].shape == (35,) and abs(got["targets"].sum() - 1) < 1e-6
    assert ds.draw_params(0, random.Random(0))[1] is not None  # drawn in training


@pytest.mark.parametrize("flag", ["--audio-augmentation.gain.enable",
                                  "--audio-augmentation.audio-resample.enable",
                                  "--audio-augmentation.mfccs.enable"])
def test_transforms_no_yaml_sets_refuse_naming_their_item(speech_folder, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 6"):
        _datasets(speech_folder, [flag])


# ------------------------------------------------------------- entry points

@pytest.fixture(scope="module")
def jpeg_folder(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("byteformer_jpegs")
    rng = np.random.default_rng(2)
    for c in range(3):
        (root / f"n0{c}").mkdir()
        for i in range(4):
            h, w = int(rng.integers(50, 90)), int(rng.integers(50, 90))
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                root / f"n0{c}" / f"img_{i}.jpg", quality=90)
    return str(root)


def _run(yaml, roots, results, max_epochs=None):
    """main_train's Trainer on a micro copy of ``yaml`` (2 epochs unless the
    run stops after ``max_epochs``), recording its validations."""
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer

    built, stats = [], {"val": [], "ema": []}

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if max_epochs is not None:
                self.max_epochs = max_epochs
            built.append(self)

        def val_epoch(self, epoch, use_ema=False):
            out = super().val_epoch(epoch, use_ema=use_ema)
            stats["ema" if use_ema else "val"].append(out)
            return out

    overrides = [f"dataset.root_train={roots}", f"dataset.root_val={roots}",
                 "dataset.workers=2", "dataset.train_batch_size0=4",
                 "dataset.val_batch_size0=4", "model.classification.byteformer.mode=micro",
                 "scheduler.max_epochs=2", f"common.results_loc={results}"]
    if yaml == JPEG_YAML:
        overrides += ["sampler.bs.crop_size_width=48", "sampler.bs.crop_size_height=48",
                      "image_augmentation.resize.size=48"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(main_train, "Trainer", Recorded)
        trainer = main_train.main_worker(args=["--common.config-file", yaml,
                                               "--common.override-kwargs", *overrides],
                                         device="cpu")
    assert trainer is built[-1]
    return trainer, stats


@pytest.fixture(scope="module", params=["jpeg", "wav"])
def unbroken(request, tmp_path_factory, jpeg_folder, speech_folder):
    yaml, roots = {"jpeg": (JPEG_YAML, jpeg_folder), "wav": (WAV_YAML, speech_folder)}[
        request.param]
    return (request.param, yaml, roots) + _run(yaml, roots, tmp_path_factory.mktemp("whole"))


def test_yaml_trains_through_main_train_on_token_batches(unbroken):
    name, _, _, trainer, stats = unbroken
    opts = trainer.opts
    assert getattr(opts, "model.classification.name") == "byteformer"
    assert type(trainer.model).__name__ == ("ByteFormer" if name == "jpeg" else "AudioByteFormer")
    assert trainer.train_iterations == trainer.state.step == 6  # 2 epochs of 12 / 4
    assert len(stats["val"]) == len(stats["ema"]) == 2
    assert all(math.isfinite(v) for s in stats["val"] + stats["ema"] for v in s.values())
    assert "checkpoint_ema_last.pt" in os.listdir(trainer.save_dir)


def test_a_run_stopped_after_its_first_epoch_resumes_bit_identical(unbroken, tmp_path):
    _, yaml, roots, whole, whole_stats = unbroken
    first, first_stats = _run(yaml, roots, tmp_path, max_epochs=1)
    assert first.train_iterations == 3 and len(first_stats["val"]) == 1
    resumed, resumed_stats = _run(yaml, roots, tmp_path)  # the yaml's auto_resume
    assert (resumed.start_epoch, resumed.state.step) == (1, 6)
    for a, b in ((whole.model, resumed.model), (whole.state.ema.model, resumed.state.ema.model)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), key
    opt_a, opt_b = whole.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i, st in opt_a["state"].items():
        assert all(torch.equal(st[k], opt_b["state"][i][k]) for k in st), i
    assert resumed_stats["ema"][-1] == whole_stats["ema"][-1]


@pytest.mark.parametrize("name", ["BYTEFORMER_ARGS", "BYTEFORMER_WAV_ARGS"])
def test_chip_smoke_byteformer_flags_are_the_yaml_settings(name):
    """Every value chip_smoke.py's flag list sets is the yaml's, and nothing
    the yaml sets is left out but its dataset's roots (and, for the JPEG
    yaml, its dataset's name: the phase names the corpus it writes)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from cvnets_tpu_torch.options.opts import get_training_arguments

    yaml_path = {"BYTEFORMER_ARGS": JPEG_YAML, "BYTEFORMER_WAV_ARGS": WAV_YAML}[name]
    default = vars(get_training_arguments(args=[]))
    flags = vars(get_training_arguments(args=getattr(chip_smoke, name)))
    yaml = vars(get_training_arguments(args=["--common.config-file", yaml_path]))

    def same(flag, value):  # a one-entry list of an ``nargs="+"`` flag is its entry
        return flag == value or (isinstance(flag, list) and flag == [value])

    set_by_flags = {k for k, v in flags.items() if v != default[k]}
    for dest in sorted(set_by_flags - {"common.seed"}):
        assert same(flags[dest], yaml[dest]), dest
    for dest, value in yaml.items():
        if value != default[dest] and dest not in (
                "common.config_file", "taskname", "dataset.root_train", "dataset.root_val",
                "dataset.name"):
            assert same(flags[dest], value), dest
