"""Feature Pyramid Network (counterpart of cvnets_tpu/modules/feature_pyramid.py):
a 1×1 lateral conv (+ norm) a level, top-down accumulation by nearest
upsampling (``jax.image.resize``'s "nearest", half-pixel centers, which is
``F.interpolate``'s "nearest-exact"), and a 3×3 output conv (+ norm) a level.
Scopes ``lateral_{i}`` and ``out_{i}`` as in flax."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d


class FeaturePyramidNetwork(nn.Module):
    def __init__(self, opts, in_channels: Sequence[int], out_channels: int = 256) -> None:
        super().__init__()
        self.n_levels = len(in_channels)
        for i, ch in enumerate(in_channels):
            self.add_module(f"lateral_{i}", ConvLayer2d(opts, ch, out_channels, 1,
                                                        use_act=False))
            self.add_module(f"out_{i}", ConvLayer2d(opts, out_channels, out_channels, 3,
                                                    use_act=False))

    def forward(self, feature_maps: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral_{i}")(fm) for i, fm in enumerate(feature_maps)]
        for i in range(len(laterals) - 2, -1, -1):
            laterals[i] = laterals[i] + F.interpolate(
                laterals[i + 1], size=laterals[i].shape[-2:], mode="nearest-exact")
        return [getattr(self, f"out_{i}")(lat) for i, lat in enumerate(laterals)]
