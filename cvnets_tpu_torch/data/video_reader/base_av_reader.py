"""Video readers (counterpart of cvnets_tpu/data/video_reader/base_av_reader.py).

A reader turns a video (a folder of frame images, or a container file) into
``{"video": (n_clips, T, H, W, 3) uint8, "audio": (n_clips, samples,
channels) float32 or None, "metadata": {...}}``: the JAX reader's frames,
which it gives as float32 in [0, 1] (each is k / 255 of these). Its random
choices are split from its work, as the image datasets' are:
``draw(path, rng)`` takes them from the loader's ``random.Random`` (each
clip's first frame in training; under ``--frame-augmentation.random-erase``
each frame's erasing), in the order the JAX reader takes them from the
global ``random``; ``read_video(path, params)`` reads. Evaluation clips are
spread evenly over the video and draw nothing.

Readers: ``frame_folder`` (ordered ``.jpg``/``.jpeg``/``.png`` frames; a
sidecar ``audio.wav`` in the folder, or ``<folder>.wav`` beside it, is cut
into each clip's span at ``--video-reader.frame-fps``), ``mp4`` (the
pure-Python demuxer of ``mp4_demux.py``: MJPEG video, PCM audio),
``pyav``, ``decord`` and ``ffmpeg`` (each needs its library or binary and
fails naming it where it is missing, as in JAX), and ``default`` (a folder
as ``frame_folder``, a file through PyAV, else ffmpeg, else ``mp4``). The
per-frame augmentations of ``--frame-augmentation.*`` run in training:
random erasing is ported; AutoAugment and timm's RandAugment raise (ROADMAP
queue 1 item 13).
"""

from __future__ import annotations

import argparse
import math
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from cvnets_tpu_torch.data.video_reader import VIDEO_READER_REGISTRY
from cvnets_tpu_torch.utils import logger

FRAME_EXTNS = (".jpg", ".jpeg", ".png")
ERASE_SCALE, ERASE_RATIO = (0.02, 0.33), (0.3, 3.3)


class _Source:
    """One opened video: its frame count, each frame as a Pillow RGB image,
    its fps and the audio it carries."""

    n_frames = 0
    fps: Optional[float] = None

    def frame(self, i: int):
        raise NotImplementedError

    def frame_hw(self) -> Tuple[int, int]:
        img = self.frame(0)
        return img.height, img.width

    def audio(self) -> Optional[Tuple[np.ndarray, float]]:
        """((samples, channels) float32 in [-1, 1], rate), or None."""
        return None


class _FolderSource(_Source):
    def __init__(self, path: str) -> None:
        self.path = path
        self.names = sorted(f for f in os.listdir(path) if f.lower().endswith(FRAME_EXTNS))
        self.n_frames = len(self.names)

    def frame(self, i: int):
        from PIL import Image

        with Image.open(os.path.join(self.path, self.names[i])) as img:
            return img.convert("RGB")

    def frame_hw(self) -> Tuple[int, int]:
        from PIL import Image

        with Image.open(os.path.join(self.path, self.names[0])) as img:  # the header only
            return img.height, img.width

    def audio(self):
        import wave

        for wav in (os.path.join(self.path, "audio.wav"), self.path.rstrip("/") + ".wav"):
            if os.path.isfile(wav):
                with wave.open(wav, "rb") as w:
                    rate, n_ch = float(w.getframerate()), w.getnchannels()
                    raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
                return (raw.astype(np.float32) / 32768.0).reshape(-1, n_ch), rate
        return None


class _FrameListSource(_Source):
    """Frames already decoded (PyAV, decord, ffmpeg), as uint8 HWC arrays."""

    def __init__(self, frames: List[np.ndarray]) -> None:
        self.frames, self.n_frames = frames, len(frames)

    def frame(self, i: int):
        from PIL import Image

        return Image.fromarray(self.frames[i])


class _Mp4Source(_Source):
    def __init__(self, data: bytes, tracks: List[Dict]) -> None:
        from cvnets_tpu_torch.data.video_reader.mp4_demux import decode_mjpeg_track

        video = [t for t in tracks if t.get("handler") == "vide"
                 or (t["codec"] in ("jpeg", "mjpa", "mjpb") and t.get("handler") is None)]
        self.track = video[0] if video else None
        self.data, self.tracks = data, tracks
        if self.track is None:
            return
        if self.track["codec"] not in ("jpeg", "mjpa", "mjpb"):
            logger.error(f"mp4 reader: codec '{self.track['codec']}' needs a codec library "
                         "(PyAV/ffmpeg); only MJPEG tracks decode natively")
        self.frames = decode_mjpeg_track(data, self.track)
        self.n_frames = len(self.frames)
        if self.track["durations"] and self.track.get("timescale"):
            self.fps = self.track["timescale"] / (float(np.mean(self.track["durations"]))
                                                  or 1.0)

    def frame(self, i: int):
        return self.frames[i]

    def audio(self):
        from cvnets_tpu_torch.data.video_reader.mp4_demux import decode_pcm_track

        sound = [t for t in self.tracks if t.get("handler") == "soun"
                 and t["codec"] in ("sowt", "twos", "lpcm", "raw ")]
        if not sound:
            return None
        wave = decode_pcm_track(self.data, sound[0])
        if wave is None or not wave.size:
            return None
        return wave, float(sound[0].get("audio_rate") or sound[0].get("timescale") or 16000)


class BaseAVReader:
    """Clip sampling and the per-frame augmentations (base_av_reader.py:23-156)."""

    def __init__(self, opts, is_training: bool = False, *args, **kwargs) -> None:
        self.opts = opts
        self.is_training = is_training
        # the dataset-level spellings win over the reader's (:30-36)
        self.frames_per_clip = (getattr(opts, "dataset.n_frames_per_clip", None)
                                or getattr(opts, "video_reader.frames_per_clip", 8))
        self.clips_per_video = (getattr(opts, "dataset.clips_per_video", None)
                                or getattr(opts, "video_reader.clips_per_video", 1))
        self.frame_fps = getattr(opts, "video_reader.frame_fps", 30.0)
        self.erase_p = None
        if is_training:
            for name in ("auto_augment", "rand_augment"):
                if getattr(opts, f"frame_augmentation.{name}.enable", False):
                    raise NotImplementedError(
                        f"not ported yet: --frame-augmentation.{name.replace('_', '-')} "
                        "runs Pillow's host policies (ROADMAP.md queue 1 item 13)")
            if getattr(opts, "frame_augmentation.random_erase.enable", False):
                self.erase_p = getattr(opts, "frame_augmentation.random_erase.p", 0.5)
        self._rng = random.Random(getattr(opts, "common.seed", 0) or 0)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseAVReader:
            return parser
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--video-reader.frames-per-clip", type=int, default=8)
        group.add_argument("--video-reader.clips-per-video", type=int, default=1)
        group.add_argument("--dataset.n-frames-per-clip", type=int, default=None)
        group.add_argument("--dataset.clips-per-video", type=int, default=None)
        group.add_argument("--video-reader.frame-fps", type=float, default=30.0,
                           help="Frames a second of a frame folder (its sidecar audio's "
                                "clock)")
        group.add_argument("--video-reader.fast-video-decoding", action="store_true",
                           default=False, help="Config-compat; frames decode in the "
                                               "loader's threads")
        group.add_argument("--video-reader.frame-stack-format", type=str,
                           default="sequence_first",
                           choices=["sequence_first", "channel_first"],
                           help="Config-compat; a clip is (T, C, H, W) either way")
        return parser

    # ---------------------------------------------------------------- sources
    def open(self, path: str) -> Optional[_Source]:
        """The video at ``path``, or None where there is none to read."""
        raise NotImplementedError

    # ------------------------------------------------------------------ draws
    def sample_frame_ids(self, total: int, rng: random.Random) -> List[List[int]]:
        """Each clip's frame indices (:136-154): a random start in training,
        starts spread evenly at evaluation, the last frame repeated where the
        video is shorter than a clip."""
        t = self.frames_per_clip
        clips = []
        for ci in range(self.clips_per_video):
            if total <= t:
                ids = list(range(total)) + [total - 1] * (t - total)
            elif self.is_training:
                start = rng.randint(0, total - t)
                ids = list(range(start, start + t))
            else:
                start = (int(ci * (total - t) / max(1, self.clips_per_video - 1))
                         if self.clips_per_video > 1 else (total - t) // 2)
                ids = list(range(start, start + t))
            clips.append(ids)
        return clips

    def draw_erase(self, rng: random.Random, hw: Tuple[int, int]) -> Optional[tuple]:
        """One frame's random erasing, drawn as the JAX ``RandomErasing``
        draws (image_advanced.py:550-566): (top, left, height, width, fill
        seed), or None."""
        if rng.random() >= self.erase_p:
            return None
        h, w = hw
        for _ in range(10):
            target = h * w * rng.uniform(*ERASE_SCALE)
            aspect = math.exp(rng.uniform(*map(math.log, ERASE_RATIO)))
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                top, left = rng.randint(0, h - eh), rng.randint(0, w - ew)
                return top, left, eh, ew, rng.getrandbits(32)
        return None

    def draw(self, path: str, rng: random.Random, source: Optional[_Source] = None
             ) -> Optional[Dict]:
        """The random choices of one read, or None where the video is empty."""
        source = source or self.open(path)
        if source is None or source.n_frames == 0:
            return None
        clip_ids = self.sample_frame_ids(source.n_frames, rng)
        erase = None
        if self.erase_p is not None:
            hw = source.frame_hw()
            erase = [[self.draw_erase(rng, hw) for _ in ids] for ids in clip_ids]
        return {"clip_ids": clip_ids, "erase": erase}

    # ------------------------------------------------------------------- work
    @staticmethod
    def erase(frame: np.ndarray, params: Optional[tuple]) -> np.ndarray:
        if params is None:
            return frame
        top, left, eh, ew, seed = params
        frame = frame.copy()
        frame[top:top + eh, left:left + ew] = np.random.RandomState(seed).randint(
            0, 256, (eh, ew) + frame.shape[2:], np.uint8)
        return frame

    def _clip_audio(self, source: _Source, clip_ids: List[List[int]], fps: float):
        found = source.audio()
        if found is None:
            return None
        audio, rate = found
        seg_len = max(1, int(round(self.frames_per_clip / fps * rate)))
        segs = []
        for ids in clip_ids:
            start = int(round(ids[0] / fps * rate))
            seg = audio[start:start + seg_len]
            if seg.shape[0] < seg_len:
                seg = np.pad(seg, ((0, seg_len - seg.shape[0]), (0, 0)))
            segs.append(seg)
        return np.stack(segs), rate

    def read_video(self, path: str, params: Optional[Dict] = None) -> Optional[Dict]:
        """The clips of ``params`` (drawn from the reader's own generator when
        None), or None where there is no video to read."""
        source = self.open(path)
        if source is None or source.n_frames == 0:
            return None
        if params is None:
            params = self.draw(path, self._rng, source)
        clips = []
        for ci, ids in enumerate(params["clip_ids"]):
            frames = [np.asarray(source.frame(i), np.uint8) for i in ids]
            if params["erase"] is not None:
                frames = [self.erase(f, e) for f, e in zip(frames, params["erase"][ci])]
            clips.append(np.stack(frames))
        fps = source.fps or self.frame_fps
        out = {"video": np.stack(clips), "audio": None, "metadata": {"video_fps": fps}}
        audio = self._clip_audio(source, params["clip_ids"], fps)
        if audio is not None:
            out["audio"], out["metadata"]["audio_fps"] = audio
        return out


VIDEO_READER_REGISTRY.register(name="__base__")(BaseAVReader)


@VIDEO_READER_REGISTRY.register(name="frame_folder")
class FrameFolderReader(BaseAVReader):
    def open(self, path: str) -> Optional[_Source]:
        return _FolderSource(path) if os.path.isdir(path) else None


@VIDEO_READER_REGISTRY.register(name="mp4")
class MP4Reader(BaseAVReader):
    def open(self, path: str) -> Optional[_Source]:
        from cvnets_tpu_torch.data.video_reader.mp4_demux import parse_mp4

        try:
            with open(path, "rb") as f:
                data = f.read()
            tracks = parse_mp4(data)
        except Exception:
            return None
        source = _Mp4Source(data, tracks)
        return source if source.track is not None else None


@VIDEO_READER_REGISTRY.register(name="pyav")
class PyAVReader(BaseAVReader):
    def __init__(self, opts, *args, **kwargs) -> None:
        super().__init__(opts, *args, **kwargs)
        try:
            import av  # noqa: F401
        except ImportError:
            logger.error("PyAV is not available in this environment; use the "
                         "'frame_folder' video reader (pre-extract frames).")

    def open(self, path: str) -> Optional[_Source]:
        import av

        with av.open(path) as container:
            return _FrameListSource([f.to_ndarray(format="rgb24")
                                     for f in container.decode(video=0)])


@VIDEO_READER_REGISTRY.register(name="decord")
class DecordReader(BaseAVReader):
    def __init__(self, opts, *args, **kwargs) -> None:
        super().__init__(opts, *args, **kwargs)
        try:
            import decord  # noqa: F401
        except ImportError:
            logger.error("decord is not available in this environment; use the "
                         "'frame_folder' video reader (pre-extract frames).")

    def open(self, path: str) -> Optional[_Source]:
        import decord

        vr = decord.VideoReader(path)
        return _FrameListSource(list(vr.get_batch(list(range(len(vr)))).asnumpy()))


def _ffmpeg_binary() -> Optional[str]:
    import shutil

    for name in ("ffmpeg", "ffmpeg4"):
        found = shutil.which(name)
        if found:
            return found
    return None


@VIDEO_READER_REGISTRY.register(name="ffmpeg")
class FFmpegReader(BaseAVReader):
    """Container decode by the ffmpeg command line into raw RGB frames."""

    def __init__(self, opts, *args, **kwargs) -> None:
        super().__init__(opts, *args, **kwargs)
        if _ffmpeg_binary() is None:
            logger.error("No ffmpeg binary on PATH; use the 'mp4' reader (MJPEG/PCM "
                         "containers) or 'frame_folder' (pre-extracted frames).")

    def open(self, path: str) -> Optional[_Source]:
        import json
        import subprocess

        ffmpeg = _ffmpeg_binary()
        try:
            meta = json.loads(subprocess.run(
                [ffmpeg.replace("ffmpeg", "ffprobe"), "-v", "quiet", "-print_format", "json",
                 "-show_streams", path], capture_output=True, timeout=60).stdout or b"{}")
            stream = [s for s in meta.get("streams", []) if s.get("codec_type") == "video"][0]
            w, h = int(stream["width"]), int(stream["height"])
        except Exception:
            return None
        raw = np.frombuffer(subprocess.run(
            [ffmpeg, "-v", "quiet", "-i", path, "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
            capture_output=True, timeout=600).stdout, np.uint8)
        n = raw.size // (h * w * 3)
        return _FrameListSource(list(raw[:n * h * w * 3].reshape(n, h, w, 3)))


@VIDEO_READER_REGISTRY.register(name="default")
class DefaultVideoReader(BaseAVReader):
    """A folder as ``frame_folder``; a file through PyAV, else the ffmpeg
    binary, else the ``mp4`` demuxer: the first one present."""

    def open(self, path: str) -> Optional[_Source]:
        if os.path.isdir(path):
            return FrameFolderReader.open(self, path)
        try:
            import av  # noqa: F401

            return PyAVReader.open(self, path)
        except ImportError:
            pass
        if _ffmpeg_binary() is not None:
            return FFmpegReader.open(self, path)
        return MP4Reader.open(self, path)
