"""Token merging (counterpart of cvnets_tpu/layers/token_merging.py).

Each run of ``window`` consecutive tokens of (B, N, C) becomes one token: the
sequence is padded with zeros to a multiple of the window, each run unfolded
channel-major (``[B, N/w, C, w] → C·w``, the order checkpoints are laid out
in), then the ``reduction`` Linear without a bias and the ``norm`` LayerNorm
at eps 1e-5. ``merge_tokens`` is that layout step alone; ByteFormer's
downsampler (``models/classification/byteformer.py``) adds the padding mask
to this module.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.linear_layer import LinearLayer


def merge_tokens(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, N, C) → (B, ⌈N/w⌉, C·w): zero-padded to a multiple of ``window``,
    each run of ``window`` tokens unfolded channel-major."""
    b, n, c = x.shape
    pad = (-n) % window
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    m = (n + pad) // window
    return x.reshape(b, m, window, c).transpose(2, 3).reshape(b, m, c * window)


class TokenMerging(nn.Module):
    def __init__(self, dim: int, window: int = 2) -> None:
        super().__init__()
        self.window = window
        self.reduction = LinearLayer(dim * window, dim, bias=False)
        # a flax LayerNorm without a dtype: float32 out under mixed precision
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.reduction(merge_tokens(x, self.window)))
