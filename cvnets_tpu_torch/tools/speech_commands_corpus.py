"""A seeded Speech Commands v2 folder for tests and smoke runs:

    python -m cvnets_tpu_torch.tools.speech_commands_corpus <root> [n_train n_val seed]

writes ``<root>/<word>/<k>.wav`` for each of the 35 words: ``n_train +
n_val`` one-second 16 kHz 16-bit mono clips a word (a tone at a pitch of the
word's plus seeded noise, written by the standard library's ``wave``), and
``<root>/validation_list.txt`` naming the last ``n_val`` clips of each word,
as the real set's list does (``word/file.wav``). Needs numpy only.
"""

from __future__ import annotations

import os
import sys
import wave

import numpy as np

from cvnets_tpu_torch.data.datasets.audio_classification.speech_commands_v2 import CLASSES

RATE = 16000


def clip(word_idx: int, k: int, seed: int = 0, n: int = RATE) -> np.ndarray:
    """(n,) int16: a tone at the word's pitch, a seeded phase and gain, and noise."""
    rng = np.random.default_rng([seed, word_idx, k])
    t = np.arange(n) / RATE
    tone = np.sin(2 * np.pi * (200.0 + 40.0 * word_idx) * t + rng.uniform(0, 2 * np.pi))
    x = rng.uniform(0.2, 0.6) * tone + 0.05 * rng.standard_normal(n)
    return (np.clip(x, -1.0, 1.0) * 32767).astype("<i2")


def write_speech_commands(root: str, n_train: int = 16, n_val: int = 2, seed: int = 0,
                          words=CLASSES) -> dict:
    """The folder above under ``root``; returns {"train": [paths], "val": [paths]}."""
    out = {"train": [], "val": []}
    val_names = []
    for w, word in enumerate(words):
        os.makedirs(os.path.join(root, word), exist_ok=True)
        for k in range(n_train + n_val):
            name = f"{word}/{seed:04x}_nohash_{k}.wav"
            path = os.path.join(root, name)
            with wave.open(path, "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(RATE)
                f.writeframes(clip(CLASSES.index(word), k, seed).tobytes())
            split = "val" if k >= n_train else "train"
            out[split].append(path)
            if split == "val":
                val_names.append(name)
    with open(os.path.join(root, "validation_list.txt"), "w") as f:
        f.write("".join(f"{name}\n" for name in val_names))
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    if not 1 <= len(args) <= 4:
        sys.exit(__doc__)
    write_speech_commands(args[0], *(int(a) for a in args[1:]))
