"""Windowed transformer encoder (counterpart of
cvnets_tpu/modules/windowed_transformer.py).

A (B, N, C) sequence is padded to a multiple of the window w = min(window, N),
rolled by −shift (shift mod w), cut into (B·N/w, w, C) windows, run through a
``TransformerEncoder`` named ``block``, and put back: un-rolled on the padded
length, then sliced to N.

The masks are computed but not applied unless
``--model.classification.byteformer.mask-windowed-attn`` is set, as in the
JAX package (:83-117) and the reference it mirrors (whose published
checkpoints were trained unmasked): by default padding tokens take part in
attention, and no mask reaches ``MultiHeadAttention``, whose windows then take
the fused kernels. With the flag, every layer passes the windows' key-padding
mask, and a shifted layer also the additive mask that keeps the two groups of
the wrapped-around last window apart; an additive mask sends that layer down
the einsum route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.modules.transformer import TransformerEncoder


def window_partition_1d(x: torch.Tensor, window: int, shift: int) -> Tuple[torch.Tensor, int]:
    """(B, N, C) → (B·n_win, window, C) and the padded length: padded to a
    multiple of ``window`` first, then rolled by −``shift`` (:20-32)."""
    b, n, c = x.shape
    pad = (-n) % window
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    if shift:
        x = torch.roll(x, -shift, dims=1)
    n_pad = n + pad
    return x.reshape(b * (n_pad // window), window, c), n_pad


def windows_shift_mask(n_pad: int, window: int, shift: int,
                       device: Optional[torch.device] = None) -> torch.Tensor:
    """(n_win, window, window) additive mask: 0 everywhere but in the last
    window, where the ``window − shift`` tokens of the sequence's end and the
    ``shift`` wrapped-around ones from its start do not attend to each other
    (-inf) (:35-48)."""
    head = torch.arange(window, device=device) < window - shift
    last = torch.where(head[:, None] == head[None, :], 0.0, float("-inf"))
    mask = torch.zeros((n_pad // window, window, window), device=device)
    mask[-1] = last
    return mask


def window_reverse_1d(x: torch.Tensor, batch: int, n_orig: int, window: int,
                      shift: int) -> torch.Tensor:
    """(B·n_win, window, C) → (B, n_orig, C): un-rolled on the padded length,
    then sliced (slicing first would drop a real token where padding was
    added) (:51-59)."""
    x = x.reshape(batch, -1, x.shape[-1])
    if shift:
        x = torch.roll(x, shift, dims=1)
    return x[:, :n_orig]


class WindowedTransformerEncoder(nn.Module):
    def __init__(self, opts, embed_dim: int, ffn_latent_dim: int, num_heads: int = 8,
                 attn_dropout: float = 0.0, dropout: float = 0.0, ffn_dropout: float = 0.0,
                 window_size: int = 128, window_shift: int = 0,
                 transformer_norm_layer: str = "layer_norm",
                 stochastic_dropout: float = 0.0) -> None:
        super().__init__()
        self.window_size, self.window_shift = window_size, window_shift
        self.mask_windowed_attn = bool(getattr(
            opts, "model.classification.byteformer.mask_windowed_attn", False))
        self.block = TransformerEncoder(
            opts, embed_dim, ffn_latent_dim, num_heads=num_heads, attn_dropout=attn_dropout,
            dropout=dropout, ffn_dropout=ffn_dropout,
            transformer_norm_layer=transformer_norm_layer,
            stochastic_dropout=stochastic_dropout)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``key_padding_mask``: (B, N) bool, True where a token is padding."""
        b, n, _ = x.shape
        w = min(self.window_size, n)
        shift = self.window_shift % w if w else 0
        xw, n_pad = window_partition_1d(x, w, shift)
        mask_w = attn_mask = None
        if self.mask_windowed_attn:
            if key_padding_mask is not None:
                m = F.pad(key_padding_mask, (0, n_pad - n), value=True)
                if shift:
                    m = torch.roll(m, -shift, dims=1)
                mask_w = m.reshape(-1, w)
            if shift:
                am = windows_shift_mask(n_pad, w, shift, x.device)
                attn_mask = am.expand(b, *am.shape).reshape(-1, 1, w, w)
        yw = self.block(xw, None, mask_w, attn_mask)
        return window_reverse_1d(yw, b, n, w, shift)
