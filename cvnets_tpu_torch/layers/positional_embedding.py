"""Positional embeddings with sequence-length interpolation (counterpart of
cvnets_tpu/layers/positional_embedding.py).

A learnable (L, D) table (parameter ``pos_embed``, flax ``truncated_normal``
at std 0.02, drawn by ``init_utils.init_weights``) or a fixed sinusoidal one,
added to (B, L', D) tokens after resampling to L' (``resize_mode``
"interpolate", ViT's) or, under "slice" (ByteFormer's), its first L' rows
when L' ≤ L and the resampled table otherwise (:57-60, 73). The sinusoidal
table is not a flax parameter, so here it is a non-persistent buffer, outside
``state_dict``.
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
    resampled to the sequence length, or sliced to it under ``resize_mode``
    "slice"."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 is_learnable: bool = True, resize_mode: str = "interpolate") -> None:
        super().__init__()
        if resize_mode not in ("interpolate", "slice"):
            raise ValueError(f"resize_mode {resize_mode!r}: want 'interpolate' or 'slice'")
        self.resize_mode = resize_mode
        if is_learnable:
            self.pos_embed = nn.Parameter(torch.empty(num_embeddings, embedding_dim))
        else:
            self.pos_embed = None
            self.register_buffer("table", sinusoidal_table(num_embeddings, embedding_dim),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        table = self.pos_embed if self.pos_embed is not None else self.table
        seq_len = x.shape[1]
        if self.resize_mode == "slice" and seq_len <= table.shape[0]:
            table = table[:seq_len]
        else:
            table = interpolate_pos_embed(table, seq_len)
        return x + table[None].to(x.dtype)
