"""The port's video data path against the JAX package's on the same files
and the same draws: the readers (``frame_folder`` with its sidecar audio
and per-frame random erasing, the pure-Python MJPEG/PCM ``mp4`` demuxer,
``default``'s routing, ``pyav`` / ``decord`` failing as JAX's), the
``kinetics`` dataset and its collate, and the ten video transforms with the
image tier's aliases. The JAX code draws from the global ``random`` (and
``np.random``); ``SameStream`` points the modules that draw at one
``random.Random``, the stream the port's draws take from. Frames are
compared exactly: the JAX float32 frames are the port's uint8 ones / 255.
Files are written into ``tmp_path`` by Pillow (and by JAX's in-test MP4
muxer, ``tests/test_video.py:_make_mjpeg_mp4``)."""

from __future__ import annotations

import random
import sys
import wave

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import both_opts  # noqa: E402


def write_video(folder, n_frames: int, hw=(24, 32), seed: int = 0, audio_rate=None):
    """A folder of JPEG frames, each with its own mean, and a sidecar
    ``audio.wav`` ramp at ``audio_rate`` (10 frames a second) when given."""
    from PIL import Image

    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        frame = np.clip(rng.integers(0, 40, hw + (3,)) + 9 * i, 0, 255).astype(np.uint8)
        Image.fromarray(frame).save(folder / f"frame_{i:04d}.jpg", quality=90)
    if audio_rate:
        ramp = np.arange(int(n_frames / 10 * audio_rate), dtype=np.float32)
        with wave.open(str(folder / "audio.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(audio_rate)
            w.writeframes((ramp / ramp.size * 32767).astype("<i2").tobytes())
    return folder


class SameStream:
    """The JAX video code's draws from one ``random.Random``: the global
    ``random`` of the reader, the dataset's Pillow path, the transforms and
    the host random erasing, and ``np.random.randint`` / ``choice`` /
    ``permutation`` from a ``RandomState`` seeded from it, as the port's
    draws seed theirs."""

    def __init__(self, mp: pytest.MonkeyPatch, seed: int) -> None:
        from cvnets_tpu.data.transforms import image_advanced, video
        from cvnets_tpu.data.video_reader import base_av_reader

        self.rng = rng = random.Random(seed)
        for module in (base_av_reader, video, image_advanced):
            mp.setattr(module, "random", rng)
        mp.setattr(np.random, "randint", lambda *a, **k: np.random.RandomState(
            rng.getrandbits(32)).randint(*a, **k))


def reader_pair(args, training: bool):
    from cvnets_tpu.data.video_reader import get_video_reader as jax_reader
    from cvnets_tpu_torch.data.video_reader import get_video_reader

    opts_jax, opts_torch = both_opts(args)
    return jax_reader(opts_jax, is_training=training), get_video_reader(opts_torch,
                                                                      is_training=training)


def unit(pixels) -> np.ndarray:
    """uint8 pixels as the JAX code's float32 ones."""
    return np.asarray(pixels, np.float32) / np.float32(255.0)


def assert_same_read(want: dict, got: dict) -> None:
    assert got["video"].dtype == np.uint8
    np.testing.assert_array_equal(got["video"].astype(np.float32) / 255.0, want["video"])
    if want.get("audio") is None:
        assert got["audio"] is None
    else:
        np.testing.assert_array_equal(got["audio"], want["audio"])
        assert got["metadata"] == want["metadata"]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("n_frames", [20, 5])
def test_frame_folder_clips_and_sidecar_audio_are_jaxs(tmp_path, training, n_frames):
    """Eval clips spread over the video, training clips at random starts
    (the last frame repeated where the video is shorter than a clip), the
    wav cut to each clip's span."""
    path = str(write_video(tmp_path / "vid", n_frames, audio_rate=100))
    args = ["--video-reader.frames-per-clip", "8", "--video-reader.clips-per-video", "3",
            "--video-reader.frame-fps", "10"]
    jax_reader, reader = reader_pair(args, training)
    for seed in range(3):
        with pytest.MonkeyPatch.context() as mp:
            want = jax_reader.read_video(path) if not training else None
            if training:
                SameStream(mp, seed)
                want = jax_reader.read_video(path)
        got = reader.read_video(path, reader.draw(path, random.Random(seed)))
        assert got["video"].shape == (3, 8, 24, 32, 3) and got["audio"].shape == (3, 80, 1)
        assert_same_read(want, got)
    assert reader.read_video(str(tmp_path / "missing")) is None


def test_frame_random_erasing_draws_as_jaxs_random_erasing(tmp_path):
    path = str(write_video(tmp_path / "vid", 12))
    args = ["--video-reader.frames-per-clip", "4", "--video-reader.clips-per-video", "2",
            "--frame-augmentation.random-erase.enable", "--frame-augmentation.random-erase.p",
            "0.7"]
    jax_reader, reader = reader_pair(args, True)
    n_erased = 0
    for seed in range(4):
        with pytest.MonkeyPatch.context() as mp:
            SameStream(mp, seed)
            want = jax_reader.read_video(path)
        params = reader.draw(path, random.Random(seed))
        n_erased += sum(e is not None for clip in params["erase"] for e in clip)
        assert_same_read(want, reader.read_video(path, params))
    assert 0 < n_erased < 32
    _, eval_reader = reader_pair(args, False)
    assert eval_reader.draw(path, random.Random(0))["erase"] is None


@pytest.mark.parametrize("policy", ["auto-augment", "rand-augment"])
def test_frame_autoaugment_and_randaugment_raise_naming_their_item(policy):
    from cvnets_tpu_torch.data.video_reader import get_video_reader

    _, opts = both_opts([f"--frame-augmentation.{policy}.enable"])
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        get_video_reader(opts, is_training=True)
    get_video_reader(opts, is_training=False)  # evaluation augments nothing


def test_mp4_reader_decodes_mjpeg_and_pcm_as_jax(tmp_path):
    from test_video import _make_mjpeg_mp4

    rng = np.random.default_rng(0)
    frames = [np.clip(rng.integers(0, 8, (48, 64, 3)) + 20 * i, 0, 255).astype(np.uint8)
              for i in range(12)]
    audio = np.sin(np.linspace(0, 60, 8000 * 12 // 5)).astype(np.float32)
    path = tmp_path / "clip.mp4"
    path.write_bytes(_make_mjpeg_mp4(frames, fps=5, audio=audio, audio_rate=8000))
    args = ["--video-reader.name", "mp4", "--video-reader.frames-per-clip", "4",
            "--video-reader.clips-per-video", "2"]
    for training in (False, True):
        jax_reader, reader = reader_pair(args, training)
        with pytest.MonkeyPatch.context() as mp:
            SameStream(mp, 5)
            want = jax_reader.read_video(str(path))
        got = reader.read_video(str(path), reader.draw(str(path), random.Random(5)))
        assert got["video"].shape == (2, 4, 48, 64, 3) and got["audio"].shape == (2, 6400, 1)
        assert got["metadata"] == {"video_fps": 5.0, "audio_fps": 8000.0}
        assert_same_read(want, got)
    (tmp_path / "junk.mp4").write_bytes(b"not a container")
    assert reader.read_video(str(tmp_path / "junk.mp4")) is None


def test_default_reader_routes_folders_and_files(tmp_path):
    from test_video import _make_mjpeg_mp4

    folder = str(write_video(tmp_path / "vid", 6))
    frames = [np.full((16, 16, 3), 30 * i, np.uint8) for i in range(6)]
    (tmp_path / "c.mp4").write_bytes(_make_mjpeg_mp4(frames, fps=10))
    args = ["--video-reader.name", "default", "--video-reader.frames-per-clip", "4"]
    jax_reader, reader = reader_pair(args, False)
    for path in (folder, str(tmp_path / "c.mp4")):
        assert_same_read(jax_reader.read_video(path), reader.read_video(path))


@pytest.mark.parametrize("name", ["pyav", "decord"])
def test_pyav_and_decord_fail_naming_their_library_as_jaxs(name):
    from cvnets_tpu.data.video_reader import get_video_reader as jax_reader
    from cvnets_tpu_torch.data.video_reader import get_video_reader

    opts_jax, opts_torch = both_opts(["--video-reader.name", name])
    with pytest.raises(SystemExit) as want:
        jax_reader(opts_jax)
    with pytest.raises(SystemExit) as got:
        get_video_reader(opts_torch)
    assert str(got.value).split(" error: ")[1] == str(want.value).split(" error: ")[1]


def kinetics_root(tmp_path, n_classes: int = 2, per_class: int = 2):
    for c in range(n_classes):
        for v in range(per_class):
            write_video(tmp_path / f"class_{c}" / f"video_{v}", 9 + 3 * v + c, seed=10 * c + v)
    (tmp_path / "class_1" / "empty").mkdir()  # no frames: a corrupt sample
    return str(tmp_path)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_kinetics_items_and_the_collate_are_jaxs(tmp_path, training):
    from cvnets_tpu.data.collate.collate_functions import default_collate_fn as jax_collate
    from cvnets_tpu.data.datasets.video_classification.kinetics import KineticsDataset as Jax
    from cvnets_tpu_torch.data.datasets.video_classification.kinetics import (
        KineticsDataset,
        default_video_collate_fn,
    )

    root = kinetics_root(tmp_path)
    args = ["--dataset.root-train", root, "--dataset.root-val", root,
            "--video-reader.frames-per-clip", "4", "--video-reader.clips-per-video", "2",
            "--dataset.category", "video_classification"]
    opts_jax, opts_torch = both_opts(args)
    jax_ds, ds = Jax(opts_jax, is_training=training), KineticsDataset(opts_torch,
                                                                      is_training=training)
    assert ds.samples == jax_ds.samples and len(ds) == 5
    assert ds.share_dataset_arguments() == jax_ds.share_dataset_arguments() == {
        "model.classification.n_classes": 2}
    items, jax_items = [], []
    for idx in range(len(ds)):
        key = (20, 28, idx)
        with pytest.MonkeyPatch.context() as mp:
            SameStream(mp, idx)
            jax_items.append(jax_ds[key])
        items.append(ds.get_item(key, ds.draw_params(key, random.Random(idx))))
        got, want = items[-1], jax_items[-1]
        assert got["samples"].shape == (2, 4, 3, 20, 28) and got["samples"].dtype == torch.uint8
        np.testing.assert_array_equal(unit(got["samples"].permute(0, 1, 3, 4, 2)),
                                      want["samples"])
        assert (got["targets"], got["sample_id"]) == (want["targets"], want["sample_id"])
    assert items[2]["targets"] == -1  # class_1/empty
    batch = default_video_collate_fn(items)
    want = jax_collate(jax_items)
    assert tuple(batch["samples"].shape) == (5, 2, 4, 3, 20, 28)
    assert batch["targets"].tolist() == [int(t) for t in np.asarray(want["targets"])]
    np.testing.assert_array_equal(unit(batch["samples"].permute(0, 1, 2, 4, 5, 3)),
                                  np.asarray(want["samples"]))


def video_data(seed: int, t: int = 3, hw=(30, 40)):
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, (t,) + hw + (3,)).astype(np.uint8)
    boxes = np.array([[2, 3, 20, 25], [5, 1, 35, 28], [0, 0, 40, 30]], np.float32)[:t]
    audio = rng.standard_normal((6, 50, 1)).astype(np.float32)
    return {"video": video, "box_coordinates": boxes, "audio": audio, "crop_size": (16, 18)}


TRANSFORMS = ["video_resize", "video_random_crop", "video_random_horizontal_flip",
              "video_random_resized_crop", "video_random_short_side_resize_crop",
              "video_center_crop", "video_to_tensor", "video_crop_by_bounding_box",
              "video_shuffle_audios", "save-inputs"]
ALIASES = ["resize", "random_crop", "random_horizontal_flip", "random_resized_crop",
           "random_short_side_resize_crop", "center_crop", "to_tensor",
           "crop_by_bounding_box", "shuffle-audios"]


@pytest.mark.parametrize("name", TRANSFORMS)
def test_every_video_transform_gives_jaxs_clip_on_the_same_draws(tmp_path, name):
    from cvnets_tpu.data.transforms import TRANSFORMATIONS_REGISTRY as JAX_REGISTRY
    from cvnets_tpu_torch.data.transforms import TRANSFORMATIONS_REGISTRY

    args = ["--video-augmentation.resize.size", "20",
            "--video-augmentation.random-short-side-resize-crop.short-side-min", "20",
            "--video-augmentation.random-short-side-resize-crop.short-side-max", "36",
            "--video-augmentation.crop-by-bounding-box.multiplier", "1.3",
            "--video-augmentation.save-inputs.enable",
            "--video-augmentation.save-inputs.save-dir", str(tmp_path / "{}")]
    opts_jax, opts_torch = both_opts(args)
    for seed in range(4):
        setattr(opts_jax, "video_augmentation.save_inputs.save_dir", str(tmp_path / "jax"))
        setattr(opts_torch, "video_augmentation.save_inputs.save_dir", str(tmp_path / "port"))
        with pytest.MonkeyPatch.context() as mp:
            stream = SameStream(mp, seed)
            state = np.random.RandomState(random.Random(seed).getrandbits(32))
            mp.setattr(np.random, "choice", state.choice)
            mp.setattr(np.random, "permutation", state.permutation)
            data = video_data(seed)
            data["video"] = data["video"].astype(np.float32) / 255.0
            want = JAX_REGISTRY[name, "video"](opts_jax)(data)
            del stream
        got = TRANSFORMATIONS_REGISTRY[name, "video"](opts_torch)(video_data(seed),
                                                                  random.Random(seed))
        video = got["video"]
        if name == "video_to_tensor":
            assert video.dtype == torch.uint8 and video.shape[1] == 3
            video = video.permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(np.asarray(video, np.float32) / 255.0, want["video"])
        for key in ("audio", "is_shuffled"):
            if key in want:
                np.testing.assert_array_equal(got[key], want[key])
    if name == "video_shuffle_audios":
        assert want["is_shuffled"].sum() >= 2
    if name == "save-inputs":
        for side in ("jax", "port"):
            assert sorted(p.name for p in (tmp_path / side).rglob("*.png"))[:1] == [
                "clip00_frame0000.png"]


def test_aliases_are_the_jax_names():
    from cvnets_tpu.data.transforms import TRANSFORMATIONS_REGISTRY as JAX_REGISTRY
    from cvnets_tpu_torch.data.transforms import TRANSFORMATIONS_REGISTRY

    def video_names(registry):
        return sorted(k.split(":", 1)[1] for k in registry.keys() if k.startswith("video:"))

    assert video_names(TRANSFORMATIONS_REGISTRY) == sorted(TRANSFORMS + ALIASES)
    assert set(video_names(JAX_REGISTRY)) >= set(TRANSFORMS + ALIASES)
    for name, alias in zip(TRANSFORMS, ALIASES):
        assert TRANSFORMATIONS_REGISTRY[alias, "video"] is TRANSFORMATIONS_REGISTRY[name,
                                                                                   "video"]
