"""Positional embeddings with sequence-length interpolation (counterpart of
cvnets_tpu/layers/positional_embedding.py).

A learnable (L, D) table (parameter ``pos_embed``, flax ``truncated_normal``
at std 0.02, drawn by ``init_utils.init_weights``) or a fixed sinusoidal one,
added to (B, L', D) tokens after resampling to L'. The sinusoidal table is not a
flax parameter, so here it is a non-persistent buffer, outside ``state_dict``.
The JAX module's "slice" resize mode (ByteFormer's) is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def sinusoidal_table(num_embeddings: int, dim: int) -> torch.Tensor:
    position = torch.arange(num_embeddings, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim))
    table = torch.zeros((num_embeddings, dim), dtype=torch.float32)
    table[:, 0::2] = torch.sin(position * div)
    table[:, 1::2] = torch.cos(position * div[: dim // 2])
    return table


def interpolate_pos_embed(pos: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linearly resample a (L, D) table along L to (target_len, D): half-pixel
    coordinates and no antialiasing, as positional_embedding.py:29-46."""
    src_len = pos.shape[0]
    if src_len == target_len:
        return pos
    scale = src_len / target_len
    coords = (torch.arange(target_len, dtype=torch.float32, device=pos.device) + 0.5) * scale - 0.5
    coords = coords.clamp(0.0, src_len - 1)
    lo = coords.floor().long()
    hi = (lo + 1).clamp(max=src_len - 1)
    w = (coords - lo.float())[:, None]
    return pos[lo] * (1.0 - w) + pos[hi] * w


class PositionalEmbedding(nn.Module):
    """Additive positional embedding over (B, L, D) token tensors; the table is
    resampled to the sequence length."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 is_learnable: bool = True) -> None:
        super().__init__()
        if is_learnable:
            self.pos_embed = nn.Parameter(torch.empty(num_embeddings, embedding_dim))
        else:
            self.pos_embed = None
            self.register_buffer("table", sinusoidal_table(num_embeddings, embedding_dim),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        table = self.pos_embed if self.pos_embed is not None else self.table
        return x + interpolate_pos_embed(table, x.shape[1])[None].to(x.dtype)
