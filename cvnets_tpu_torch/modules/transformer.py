"""Transformer blocks (counterpart of cvnets_tpu/modules/transformer.py). Only
``LinearAttnFFN`` (:88-127), the MobileViTv2 block, is ported."""

from __future__ import annotations

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.layers.normalization import get_normalization_layer


class LinearAttnFFN(nn.Module):
    """Pre-norm separable attention + FFN on (B, P, N, C) patches."""

    def __init__(self, opts, embed_dim: int, ffn_latent_dim: int,
                 attn_dropout: float = 0.0, dropout: float = 0.0,
                 ffn_dropout: float = 0.0, norm_layer: str = "layer_norm_2d") -> None:
        super().__init__()
        self.pre_norm_attn = get_normalization_layer(opts, embed_dim, norm_layer) \
            or nn.Identity()
        self.attn = LinearSelfAttention(opts, embed_dim, attn_dropout=attn_dropout)
        self.pre_norm_ffn = get_normalization_layer(opts, embed_dim, norm_layer) \
            or nn.Identity()
        self.ffn_fc1 = LinearLayer(embed_dim, ffn_latent_dim)
        self.act = build_act_layer(opts)
        self.ffn_fc2 = LinearLayer(ffn_latent_dim, embed_dim)
        self.dropout = nn.Dropout(dropout)
        self.ffn_dropout = nn.Dropout(ffn_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.dropout(self.attn(self.pre_norm_attn(x)))
        y = self.ffn_dropout(self.act(self.ffn_fc1(self.pre_norm_ffn(x))))
        return x + self.dropout(self.ffn_fc2(y))
