"""RangeAugment's neural augmentor (counterpart of
cvnets_tpu/models/neural_augmentor/): its flags here, the module in
``neural_aug.py``. ``--model.learn-augmentation.lr-multiplier`` is parsed and
never applied, as in the JAX package (no other use of it there); a value
other than 1.0 is reported when the augmentor is built."""

from __future__ import annotations

import argparse


def arguments_neural_augmentor(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Neural augmentor (RangeAugment)")
    group.add_argument("--model.learn-augmentation.mode", type=str, default=None,
                       choices=[None, "basic", "distribution"])
    group.add_argument("--model.learn-augmentation.brightness", action="store_true")
    group.add_argument("--model.learn-augmentation.contrast", action="store_true")
    group.add_argument("--model.learn-augmentation.noise", action="store_true")
    group.add_argument("--model.learn-augmentation.lr-multiplier", type=float, default=1.0)
    return parser
