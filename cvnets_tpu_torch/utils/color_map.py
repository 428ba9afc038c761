"""Segmentation colour maps (counterpart of cvnets_tpu/utils/color_map.py): the
PASCAL VOC palette, each index's bits spread over R, G and B."""

from __future__ import annotations

from typing import List

import numpy as np


class Colormap:
    def __init__(self, n: int = 256, normalized: bool = False) -> None:
        self.n = n
        self.normalized = normalized

    def get_color_map(self) -> np.ndarray:
        def bitget(byteval, idx):
            return (byteval & (1 << idx)) != 0

        cmap = np.zeros((self.n, 3), dtype="float32" if self.normalized else "uint8")
        for i in range(self.n):
            r = g = b = 0
            c = i
            for j in range(8):
                r |= bitget(c, 0) << (7 - j)
                g |= bitget(c, 1) << (7 - j)
                b |= bitget(c, 2) << (7 - j)
                c >>= 3
            cmap[i] = np.array([r, g, b])
        return cmap / 255.0 if self.normalized else cmap

    def get_color_map_list(self) -> List[int]:
        return self.get_color_map().reshape(-1).tolist()
