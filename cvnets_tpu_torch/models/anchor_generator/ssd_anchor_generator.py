"""SSD anchors (counterpart of cvnets_tpu/models/anchor_generator/ssd_anchor_generator.py).

Center-form anchors [cx, cy, w, h] in [0, 1] for a feature map of (h, w) at an
output stride, made on the host with numpy, as the JAX generator makes them
(float32, the same arithmetic), and kept per (h, w, stride): the data path
matches boxes against them on the host, and the SSD model keeps a copy of each
set on its device (``SingleShotMaskDetector.anchors``).
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np

from cvnets_tpu_torch.models.anchor_generator import ANCHOR_GEN_REGISTRY


class BaseAnchorGenerator:
    """Anchors per (h, w, output stride), made once each."""

    def __init__(self, *args, **kwargs) -> None:
        self.anchors_dict: Dict = {}

    def num_anchors_per_os(self) -> List[int]:
        raise NotImplementedError

    def _generate_anchors(self, height: int, width: int, output_stride: int) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, fm_height: int, fm_width: int, fm_output_stride: int) -> np.ndarray:
        key = (fm_height, fm_width, fm_output_stride)
        if key not in self.anchors_dict:
            self.anchors_dict[key] = self._generate_anchors(fm_height, fm_width,
                                                            fm_output_stride)
        return self.anchors_dict[key]


@ANCHOR_GEN_REGISTRY.register(name="ssd")
class SSDAnchorGenerator(BaseAnchorGenerator):
    def __init__(self, opts, *args, **kwargs) -> None:
        super().__init__()
        prefix = "anchor_generator.ssd."
        output_strides = getattr(opts, prefix + "output_strides", None) or [32, 64, 128, 256, -1]
        aspect_ratios = (getattr(opts, prefix + "aspect_ratios", None)
                         or [[2, 3]] * len(output_strides))
        min_ratio = getattr(opts, prefix + "min_scale_ratio", None)
        min_ratio = 0.1 if min_ratio is None else min_ratio
        max_ratio = getattr(opts, prefix + "max_scale_ratio", None)
        max_ratio = 1.05 if max_ratio is None else max_ratio
        step = getattr(opts, prefix + "step", [1]) or [1]
        if isinstance(step, int):
            step = [step] * len(output_strides)
        step = list(step) + [1] * (len(output_strides) - len(step))

        aspect_ratios = [sorted(set(ar)) for ar in aspect_ratios]
        self.output_strides_aspect_ratio = dict(zip(output_strides, aspect_ratios))
        self.output_strides = output_strides
        scales = np.linspace(min_ratio, max_ratio, len(output_strides) + 1)
        self.sizes = {s: {"min": scales[i], "max": (scales[i] * scales[i + 1]) ** 0.5,
                          "step": step[i]}
                      for i, s in enumerate(output_strides)}
        self.clip = not getattr(opts, prefix + "no_clipping", False)
        self.min_scale_ratio, self.max_scale_ratio = min_ratio, max_ratio

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        prefix = "--anchor-generator.ssd."
        group.add_argument(prefix + "output-strides", nargs="+", type=int, default=None)
        group.add_argument(prefix + "aspect-ratios", nargs="+", type=float, action="append",
                           default=None)
        group.add_argument(prefix + "min-scale-ratio", type=float, default=None)
        group.add_argument(prefix + "max-scale-ratio", type=float, default=None)
        group.add_argument(prefix + "no-clipping", action="store_true")
        group.add_argument(prefix + "step", type=int, nargs="+", default=[1])
        return parser

    def num_anchors_per_os(self) -> List[int]:
        return [2 + 2 * len(ar) for ar in self.output_strides_aspect_ratio.values()]

    def _generate_anchors(self, height: int, width: int, output_stride: int) -> np.ndarray:
        size = self.sizes[output_stride]
        min_s, max_s = size["min"], size["max"]
        step = max(1, size["step"])
        start = max(0, step // 2)
        ys = (np.arange(start, height, step) + 0.5) / height
        xs = (np.arange(start, width, step) + 0.5) / width
        cy, cx = np.meshgrid(ys, xs, indexing="ij")
        centers = np.stack([cx.reshape(-1), cy.reshape(-1)], axis=-1)  # (P, 2)
        whs = [[min_s, min_s], [max_s, max_s]]
        for ratio in self.output_strides_aspect_ratio[output_stride]:
            r = ratio ** 0.5
            whs += [[min_s * r, min_s / r], [min_s / r, min_s * r]]
        whs = np.asarray(whs, np.float32)  # (A, 2)
        p, a = centers.shape[0], whs.shape[0]
        anchors = np.concatenate([np.repeat(centers, a, axis=0), np.tile(whs, (p, 1))],
                                 axis=-1).astype(np.float32)
        return np.clip(anchors, 0.0, 1.0) if self.clip else anchors
