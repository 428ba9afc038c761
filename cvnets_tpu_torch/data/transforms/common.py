"""Transform base and composition (counterpart of
cvnets_tpu/data/transforms/common.py).

A transform's randomness is split from its work: ``draw(rng, size_hw)`` takes
its random parameters from an explicit ``random.Random`` given the image's
(height, width) and returns them with the output's (height, width);
``apply(data, params)`` does the work. The loader draws every sample's
parameters in sample order in one thread, before its workers decode and
transform, so a batch does not depend on the threads' timing, and
``random.Random(s)`` gives the draws that ``random.seed(s)`` gives the JAX
transforms (which draw from the global ``random``).
"""

from __future__ import annotations

import argparse
import random
from typing import Any, Dict, List, Tuple


class BaseTransformation:
    """Per-sample op over a ``{"image": uint8 CHW tensor, ...}`` dict."""

    def __init__(self, opts, *args, **kwargs) -> None:
        self.opts = opts

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        return parser

    def draw(self, rng: random.Random, size_hw: Tuple[int, int]) -> Tuple[Any, Tuple[int, int]]:
        """(params, output size) for an image of ``size_hw``; no draw by default."""
        return None, self.output_size(size_hw)

    def output_size(self, size_hw: Tuple[int, int]) -> Tuple[int, int]:
        return size_hw

    def apply(self, data: Dict, params: Any) -> Dict:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"


class Compose(BaseTransformation):
    def __init__(self, opts, img_transforms: List[BaseTransformation]) -> None:
        super().__init__(opts)
        self.img_transforms = img_transforms

    def draw(self, rng: random.Random, size_hw: Tuple[int, int]) -> Tuple[list, Tuple[int, int]]:
        params = []
        for t in self.img_transforms:
            p, size_hw = t.draw(rng, size_hw)
            params.append(p)
        return params, size_hw

    def apply(self, data: Dict, params: list) -> Dict:
        for t, p in zip(self.img_transforms, params):
            data = t.apply(data, p)
        return data

    def __repr__(self) -> str:
        return f"Compose([{', '.join(repr(t) for t in self.img_transforms)}])"
