"""Google Speech Commands v2 (counterpart of
cvnets_tpu/data/datasets/audio_classification/speech_commands_v2.py).

A folder a class (the 35 words of ``CLASSES``); ``validation_list.txt`` and
``testing_list.txt`` name the files of the validation and test splits, and
training takes every other file. ``--dataset.speech-commands.as-bytes`` is a
``store_true`` flag whose default is True, so no yaml or flag turns it off:
an item is the file's own bytes (int32), and the clip transforms never touch
them. Only options set in code (as the tests do) reach the waveform route:
the 16-bit clip as float32, cut or padded to a fixed length, with ambient
noise and a roll in training under their flags, and the waveform mixup of
``--dataset.speech-commands-v2.mixup`` (soft one-hot targets).

The waveform route's draws are split from its work, as the image datasets'
are: ``draw_params(t, rng)`` draws the transforms' parameters (and mixup's
other index and weight) from the loader's ``random.Random``, and
``get_item(t, params)`` reads and transforms.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Tuple

import numpy as np

from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
from cvnets_tpu_torch.data.datasets.dataset_base import BaseDataset
from cvnets_tpu_torch.data.transforms.audio import (
    AudioNoise,
    AudioRoll,
    SetFixedLength,
    read_wav_mono,
    refuse_unported_audio_transforms,
)

CLASSES = [
    "backward", "bed", "bird", "cat", "dog", "down", "eight", "five", "follow",
    "forward", "four", "go", "happy", "house", "learn", "left", "marvin", "nine",
    "no", "off", "on", "one", "right", "seven", "sheila", "six", "stop", "three",
    "tree", "two", "up", "visual", "wow", "yes", "zero",
]


@DATASET_REGISTRY.register(name="speech_commands_v2", type="audio_classification")
class SpeechCommandsV2(BaseDataset):
    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        refuse_unported_audio_transforms(opts)
        self.as_bytes = getattr(opts, "dataset.speech_commands.as_bytes", True)
        self.mixup = getattr(opts, "dataset.speech_commands_v2.mixup", False)
        self.class_to_idx = {c: i for i, c in enumerate(CLASSES)}
        self.samples: List[Tuple[str, int]] = self._find_samples()
        self._rng = random.Random(getattr(opts, "common.seed", 0) or 0)
        # the waveform route (:69-81): the fixed length always; noise (from
        # _background_noise_ when the root has it) and roll in training
        self._transforms = [SetFixedLength(opts)]
        if is_training:
            if getattr(opts, "audio_augmentation.noise.enable", False):
                bg = os.path.join(self.root or "", "_background_noise_")
                self._transforms.append(AudioNoise(
                    opts, noise_files_dir=bg if os.path.isdir(bg) else None, rng=self._rng))
            if getattr(opts, "audio_augmentation.roll.enable", False):
                self._transforms.append(AudioRoll(opts))
        self.length = self._transforms[0].length

    def _find_samples(self) -> List[Tuple[str, int]]:
        root, samples = self.root, []
        if not (root and os.path.isdir(root)):
            return samples
        val_list, test_list = set(), set()
        for name, bucket in (("validation_list.txt", val_list), ("testing_list.txt", test_list)):
            path = os.path.join(root, name)
            if os.path.isfile(path):
                with open(path) as f:
                    bucket.update(line.strip() for line in f if line.strip())
        for cls in CLASSES:
            cdir = os.path.join(root, cls)
            if not os.path.isdir(cdir):
                continue
            for fname in sorted(os.listdir(cdir)):
                rel = f"{cls}/{fname}"
                in_val, in_test = rel in val_list, rel in test_list
                if (self.is_training and not (in_val or in_test)) or (
                        not self.is_training and (in_test if self.is_evaluation else in_val)):
                    samples.append((os.path.join(cdir, fname), self.class_to_idx[cls]))
        return samples

    @classmethod
    def add_arguments(cls, parser):
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--dataset.speech-commands.as-bytes", action="store_true",
                           default=True)
        group.add_argument("--dataset.speech-commands-v2.mixup",
                           action="store_true", default=False)
        return parser

    def share_dataset_arguments(self) -> Dict:
        return {"model.classification.n_classes": len(CLASSES)}

    def __len__(self) -> int:
        return len(self.samples)

    def _draw_waveform(self, rng: random.Random) -> list:
        return [t.draw(rng, self.length) for t in self._transforms]

    def draw_params(self, sample_size_and_index, rng: random.Random):
        """None in bytes mode; else the transforms' parameters and, under
        mixup in training, (other index, its parameters, weight)."""
        if self.as_bytes:
            return None
        params = self._draw_waveform(rng)
        if self.mixup and self.is_training:
            other = rng.randrange(len(self.samples))
            return params, (other, self._draw_waveform(rng), rng.random())
        return params, None

    def _waveform(self, idx: int, params: list) -> Dict:
        path, target = self.samples[idx]
        audio, fps = read_wav_mono(path)
        data = {"audio": audio, "metadata": {"audio_fps": fps}}
        for t, p in zip(self._transforms, params):
            data = t.apply(data, p)
        return {"audio": data["audio"], "target": int(target)}

    def get_item(self, sample_size_and_index, params) -> Dict:
        _, _, idx = self._parse_batch_tuple(sample_size_and_index)
        if self.as_bytes:
            with open(self.samples[idx][0], "rb") as f:
                raw = np.frombuffer(f.read(), np.uint8).astype(np.int32)
            return {"samples": raw, "targets": int(self.samples[idx][1]), "sample_id": idx}
        own, mix = params
        data = self._waveform(idx, own)
        audio, target = data["audio"], data["target"]
        if mix is not None:  # waveform mixup with soft one-hot targets (:113-124)
            other_idx, other_params, lam = mix
            other = self._waveform(other_idx, other_params)
            audio = audio * lam + other["audio"] * (1.0 - lam)
            soft = np.zeros((len(CLASSES),), np.float32)
            soft[target] += lam
            soft[other["target"]] += 1.0 - lam
            return {"samples": audio.astype(np.float32), "targets": soft, "sample_id": idx}
        return {"samples": audio.astype(np.float32), "targets": target, "sample_id": idx}

    def __getitem__(self, sample_size_and_index) -> Dict:
        return self.get_item(sample_size_and_index,
                             self.draw_params(sample_size_and_index, self._rng))
