"""Transformer blocks (counterpart of cvnets_tpu/modules/transformer.py):
``TransformerEncoder`` (:30-85), the pre-norm MHA + FFN block of ViT, and
``LinearAttnFFN`` (:88-127), the MobileViTv2 block."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.layers.multi_head_attention import MultiHeadAttention
from cvnets_tpu_torch.layers.normalization import get_normalization_layer
from cvnets_tpu_torch.layers.random_layers import StochasticDepth


class TransformerEncoder(nn.Module):
    """Pre-norm MHA + FFN on (B, S, E) tokens. ``norm_eps`` is the LayerNorms'
    eps (ViT forces 1e-6). Row-wise stochastic depth with probability
    ``stochastic_dropout`` drops each residual branch after its dropout, as the
    JAX block does."""

    def __init__(self, opts, embed_dim: int, ffn_latent_dim: int, num_heads: int = 8,
                 attn_dropout: float = 0.0, dropout: float = 0.0, ffn_dropout: float = 0.0,
                 transformer_norm_layer: str = "layer_norm", act_name: Optional[str] = None,
                 stochastic_dropout: float = 0.0, norm_eps: float = 1e-5) -> None:
        super().__init__()
        self.pre_norm_mha = get_normalization_layer(
            opts, embed_dim, transformer_norm_layer, eps=norm_eps) or nn.Identity()
        self.mha = MultiHeadAttention(opts, embed_dim, num_heads, attn_dropout=attn_dropout)
        self.pre_norm_ffn = get_normalization_layer(
            opts, embed_dim, transformer_norm_layer, eps=norm_eps) or nn.Identity()
        self.ffn_fc1 = LinearLayer(embed_dim, ffn_latent_dim)
        self.act = build_act_layer(opts, act_name)
        self.ffn_fc2 = LinearLayer(ffn_latent_dim, embed_dim)
        self.dropout = nn.Dropout(dropout)
        self.ffn_dropout = nn.Dropout(ffn_dropout)
        self.stochastic_depth = StochasticDepth(stochastic_dropout)

    def forward(self, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.mha(self.pre_norm_mha(x), x_kv=x_prev, key_padding_mask=key_padding_mask,
                     attn_mask=attn_mask)
        x = x + self.stochastic_depth(self.dropout(y))
        y = self.ffn_dropout(self.act(self.ffn_fc1(self.pre_norm_ffn(x))))
        return x + self.stochastic_depth(self.dropout(self.ffn_fc2(y)))


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

    def forward(self, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x_prev``: the previous frame's patches, which q and k come from
        (not normalized here, as in JAX, :101-108)."""
        x = x + self.dropout(self.attn(self.pre_norm_attn(x), x_prev))
        y = self.ffn_dropout(self.act(self.ffn_fc1(self.pre_norm_ffn(x))))
        return x + self.dropout(self.ffn_fc2(y))
