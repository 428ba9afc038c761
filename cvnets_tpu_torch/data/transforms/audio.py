"""Audio transforms of the waveform route (counterpart of
cvnets_tpu/data/transforms/audio.py): ``set_fixed_length``,
``audio_ambient_noise`` and ``roll``, on ``{"audio": float32 (N,), "metadata":
{"audio_fps": ...}}``.

As the port's other host transforms, a random one splits its draw from its
work: ``draw(rng)`` takes the parameters from the loader's ``random.Random``
(the calls the JAX transforms make on the global ``random``, in the same
order, so ``random.Random(s)`` draws what ``random.seed(s)`` does there) and
``apply(data, params)`` uses them; white noise's normal draws come from a numpy
generator seeded from ``rng``.

``audio_gain``, ``audio-resample`` and ``mfccs`` are set by no yaml and are
not ported: their flags parse, and a dataset asked for one raises
(``UNPORTED_AUDIO_TRANSFORMS``, ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import argparse
import os
import random
import wave
from typing import Dict, List, Optional, Tuple

import numpy as np

from cvnets_tpu_torch.data.transforms import TRANSFORMATIONS_REGISTRY
from cvnets_tpu_torch.data.transforms.common import BaseTransformation
from cvnets_tpu_torch.data.transforms.image_bytes import numpy_draws

# the enable flags of the JAX transforms that the port does not run
UNPORTED_AUDIO_TRANSFORMS = ("audio_augmentation.gain.enable",
                             "audio_augmentation.audio_resample.enable",
                             "audio_augmentation.mfccs.enable")


def refuse_unported_audio_transforms(opts) -> None:
    for dest in UNPORTED_AUDIO_TRANSFORMS:
        if getattr(opts, dest, False):
            raise NotImplementedError(
                f"not ported yet: --{dest.replace('_', '-')} (ROADMAP.md queue 1 item 6)")


def read_wav_mono(path: str) -> Tuple[np.ndarray, float]:
    """A 16-bit wav file's samples as float32 in [-1, 1) and its rate."""
    with wave.open(path, "rb") as w:
        audio = np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32)
        return audio / 32768.0, float(w.getframerate())


@TRANSFORMATIONS_REGISTRY.register(name="set_fixed_length", type="audio")
class SetFixedLength(BaseTransformation):
    """Cut or zero-pad the clip to ``length`` samples (audio.py:236-259)."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.length = getattr(opts, "audio_augmentation.set_fixed_length.length", 16000)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--audio-augmentation.set-fixed-length.enable",
                           action="store_true", default=False)
        group.add_argument("--audio-augmentation.set-fixed-length.length",
                           type=int, default=16000)
        return parser

    def draw(self, rng: random.Random, n: int):
        return None

    def apply(self, data: Dict, params=None) -> Dict:
        audio = np.asarray(data["audio"], np.float32)
        if len(audio) >= self.length:
            data["audio"] = audio[: self.length]
        else:
            data["audio"] = np.pad(audio, (0, self.length - len(audio)))
        return data


@TRANSFORMATIONS_REGISTRY.register(name="audio_ambient_noise", type="audio")
class AudioNoise(BaseTransformation):
    """Ambient noise mixed in (audio.py:59-147): with ``noise_files_dir`` a
    cached noise wave, cropped at a drawn offset or tiled to the clip's
    length, at a dB level drawn from ``levels``; without one, white noise at
    an SNR drawn from [snr-low, snr-high]. ``cache_size`` files are picked by
    ``rng`` (the dataset's generator) and picked again every
    ``refresh_freq`` draws."""

    def __init__(self, opts, noise_files_dir: Optional[str] = None,
                 rng: Optional[random.Random] = None, **kwargs) -> None:
        super().__init__(opts)
        self.snr_low = getattr(opts, "audio_augmentation.noise.snr_low", 10)
        self.snr_high = getattr(opts, "audio_augmentation.noise.snr_high", 30)
        self.gain_levels = getattr(opts, "audio_augmentation.noise.levels", None) or [-100]
        self.cache_size = getattr(opts, "audio_augmentation.noise.cache_size", 10)
        self.refresh_freq = getattr(opts, "audio_augmentation.noise.refresh_freq", 0)
        self.refresh_counter = self.refresh_freq
        self.noise_files_dir = noise_files_dir or getattr(
            opts, "audio_augmentation.noise.files_dir", None)
        self.noise_waves = (self._load_noise_files(self.cache_size, rng or random.Random(0))
                            if self.noise_files_dir else [])

    def _load_noise_files(self, n: int, rng: random.Random) -> List[Tuple[np.ndarray, float]]:
        paths = [os.path.join(self.noise_files_dir, f)
                 for f in sorted(os.listdir(self.noise_files_dir)) if f.endswith(".wav")]
        return [read_wav_mono(p) for p in (rng.sample(paths, min(n, len(paths)))
                                           if paths else [])]

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--audio-augmentation.noise.enable",
                           action="store_true", default=False)
        group.add_argument("--audio-augmentation.noise.levels", type=float,
                           nargs="+", default=[-100])
        group.add_argument("--audio-augmentation.noise.cache-size", type=int, default=10)
        group.add_argument("--audio-augmentation.noise.files-dir", type=str, default=None)
        group.add_argument("--audio-augmentation.noise.refresh-freq", type=int, default=0)
        group.add_argument("--audio-augmentation.noise.snr-low", type=float, default=10)
        group.add_argument("--audio-augmentation.noise.snr-high", type=float, default=30)
        return parser

    def draw(self, rng: random.Random, n: int):
        """For a clip of ``n`` samples: ("file", gain dB, the cropped or tiled
        noise) or ("white", SNR dB, a numpy seed for the normal draws)."""
        if not self.noise_waves:
            return "white", rng.uniform(self.snr_low, self.snr_high), numpy_draws(rng)
        gain_level = rng.choice(self.gain_levels)
        noise_wave, _fps = rng.choice(self.noise_waves)
        if noise_wave.shape[-1] >= n:
            start = rng.randint(0, noise_wave.shape[-1] - n)
            noise_wave = noise_wave[start:start + n]
        else:  # tiled to the clip's length (audio.py:133-135)
            noise_wave = np.tile(noise_wave, -(-n // noise_wave.shape[-1]))[:n]
        self.refresh_counter -= 1
        if self.refresh_counter <= 0 and self.refresh_freq > 0:
            self.noise_waves = self._load_noise_files(self.cache_size, rng)
            self.refresh_counter = self.refresh_freq
        return "file", gain_level, noise_wave

    def apply(self, data: Dict, params) -> Dict:
        audio = np.asarray(data["audio"], np.float32)
        kind, level, noise = params
        if kind == "file":
            data["audio"] = audio + 10.0 ** (level / 20.0) * noise
            return data
        sig_power = np.mean(audio ** 2) + 1e-10
        noise_power = sig_power / (10 ** (level / 10))
        data["audio"] = audio + noise.randn(*audio.shape).astype(np.float32) \
            * np.sqrt(noise_power)
        return data


@TRANSFORMATIONS_REGISTRY.register(name="roll", type="audio")
class AudioRoll(BaseTransformation):
    """The clip rolled by a shift drawn from ±``window`` of its length
    (audio.py:207-227)."""

    def __init__(self, opts, **kwargs) -> None:
        super().__init__(opts)
        self.window = getattr(opts, "audio_augmentation.roll.window", 0.1)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--audio-augmentation.roll.enable",
                           action="store_true", default=False)
        group.add_argument("--audio-augmentation.roll.window", type=float, default=0.1)
        return parser

    def draw(self, rng: random.Random, n: int) -> int:
        return rng.randint(-int(n * self.window), int(n * self.window))

    def apply(self, data: Dict, params: int) -> Dict:
        data["audio"] = np.roll(np.asarray(data["audio"]), params)
        return data


class _UnportedAudioTransform(BaseTransformation):
    """A JAX transform that the port parses the flags of and does not run."""

    def __init__(self, opts, **kwargs) -> None:
        raise NotImplementedError(f"not ported yet: {type(self).__name__} "
                                  "(ROADMAP.md queue 1 item 6)")


@TRANSFORMATIONS_REGISTRY.register(name="audio-resample", type="audio")
class AudioResample(_UnportedAudioTransform):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--audio-augmentation.audio-resample.enable",
                           action="store_true", default=False)
        group.add_argument("--audio-augmentation.audio-resample.audio-fps",
                           type=int, default=None)
        group.add_argument("--audio-augmentation.audio-resample.sample-rate",
                           type=int, default=16000)
        return parser


@TRANSFORMATIONS_REGISTRY.register(name="audio_gain", type="audio")
class AudioGain(_UnportedAudioTransform):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--audio-augmentation.gain.enable",
                           action="store_true", default=False)
        group.add_argument("--audio-augmentation.gain.levels", type=float,
                           nargs="+", default=None)
        group.add_argument("--audio-augmentation.gain.db-low", type=float, default=-10.0)
        group.add_argument("--audio-augmentation.gain.db-high", type=float, default=10.0)
        return parser


@TRANSFORMATIONS_REGISTRY.register(name="mfccs", type="audio")
class MFCCs(_UnportedAudioTransform):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--audio-augmentation.mfccs.enable",
                           action="store_true", default=False)
        group.add_argument("--audio-augmentation.mfccs.num-mfccs", type=int, default=40)
        group.add_argument("--audio-augmentation.mfccs.n-fft", type=int, default=400)
        group.add_argument("--audio-augmentation.mfccs.hop-length", type=int, default=160)
        group.add_argument("--audio-augmentation.mfccs.window-length",
                           type=float, default=None,
                           help="Window length in seconds; overrides n-fft")
        group.add_argument("--audio-augmentation.mfccs.num-frames", type=int,
                           default=None)
        return parser
