"""Audio byte encodings of ByteFormer (counterpart of
cvnets_tpu/data/transforms/audio_bytes.py): ``torchaudio_save``, a clip
written as a wav file's bytes, and ``standardize_channels``.

No torchaudio: integer PCM goes through the standard library's ``wave``
writer, IEEE float32 through a hand-built 44-byte RIFF header, byte for byte
what the JAX package writes. ``format: mp3`` fails as it does there, for want
of an encoder.
"""

from __future__ import annotations

import argparse
import io
import struct
import wave
from typing import Dict

import numpy as np

from cvnets_tpu_torch.data.transforms import TRANSFORMATIONS_REGISTRY
from cvnets_tpu_torch.data.transforms.common import BaseTransformation
from cvnets_tpu_torch.utils import logger


def pcm_wav_bytes(x: np.ndarray, dtype: str, audio_fps: int) -> bytes:
    """A mono float32 clip in [-1, 1], (N,), as the bytes of a wav file of
    samples of ``dtype`` (audio_bytes.py:26-66)."""
    if dtype == "float32":
        payload = x.astype("<f4").tobytes()
        header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
        header += b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, audio_fps, audio_fps * 4, 4, 32)
        header += b"data" + struct.pack("<I", len(payload))
        return header + payload
    if dtype == "int32":
        # float32 cannot hold 2^31 - 1: the product is taken in float64
        pcm = np.clip(x.astype(np.float64) * (2 ** 31 - 1),
                      -(2 ** 31), 2 ** 31 - 1).astype("<i4")
        width = 4
    elif dtype == "int16":
        pcm = (x * (2 ** 15 - 1)).astype("<i2")
        width = 2
    elif dtype == "uint8":
        pcm = ((x + 1.0) * (2 ** 8 - 1) / 2).astype(np.uint8)
        width = 1
    else:
        raise ValueError(f"unsupported dtype {dtype}")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(audio_fps)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@TRANSFORMATIONS_REGISTRY.register(name="torchaudio_save", type="audio")
class TorchaudioSave(BaseTransformation):
    """``{"samples": {"audio": clip}, "metadata": {"audio_fps": r}}`` with the
    clip (mono (N,), or (1 | 2, N) averaged to mono) replaced by its wav
    file's bytes as int32 (audio_bytes.py:69-123)."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.encoding_dtype = getattr(
            opts, "audio_augmentation.torchaudio_save.encoding_dtype", "float32")
        self.format = getattr(opts, "audio_augmentation.torchaudio_save.format", "wav")

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--audio-augmentation.torchaudio-save.enable",
                           action="store_true", default=False)
        group.add_argument("--audio-augmentation.torchaudio-save.encoding-dtype",
                           choices=("float32", "int32", "int16", "uint8"), default="float32")
        group.add_argument("--audio-augmentation.torchaudio-save.format",
                           choices=("wav", "mp3"), default="wav")
        return parser

    def __call__(self, data: Dict) -> Dict:
        x = np.asarray(data["samples"]["audio"], np.float32)
        audio_fps = int(data.get("metadata", {}).get("audio_fps", 16000))
        if x.ndim == 2:
            if x.shape[0] not in (1, 2):
                raise ValueError(f"Expected (1|2, N) audio, got {x.shape}")
            x = x.mean(axis=0)
        elif x.ndim != 1:
            raise ValueError(f"Expected 1-D or 2-D audio, got {x.shape}")
        if self.format == "wav":
            file_bytes = pcm_wav_bytes(x, self.encoding_dtype, audio_fps)
        elif self.format == "mp3":
            logger.error("torchaudio_save: no mp3 encoder is available (the reference "
                         "delegates to torchaudio/ffmpeg); use format=wav")
        else:
            raise NotImplementedError(f"format {self.format}")
        data["samples"]["audio"] = np.frombuffer(file_bytes, dtype=np.uint8).astype(np.int32)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="standardize_channels", type="audio")
class StandardizeChannels(BaseTransformation):
    """(N, T, C) audio to ``num_channels``: 2 → 1 averages, 1 → 2 repeats
    (audio_bytes.py:126-147)."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.num_channels = getattr(
            opts, "audio_augmentation.standardize_channels.num_channels", 2)
        self.enable = getattr(opts, "audio_augmentation.standardize_channels.enable", False)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--audio-augmentation.standardize-channels.num-channels",
                           type=int, default=2)
        group.add_argument("--audio-augmentation.standardize-channels.enable",
                           action="store_true", default=False)
        return parser

    def __call__(self, data: Dict) -> Dict:
        if not self.enable:
            return data
        audio = np.asarray(data["samples"]["audio"])
        c = audio.shape[-1]
        if c == self.num_channels:
            return data
        if self.num_channels == 1:
            out = audio.mean(axis=-1, keepdims=True)
        elif c == 1:
            out = np.repeat(audio, self.num_channels, axis=-1)
        else:
            raise ValueError(f"cannot standardize {c} -> {self.num_channels} channels")
        data["samples"]["audio"] = out.astype(audio.dtype)
        return data
