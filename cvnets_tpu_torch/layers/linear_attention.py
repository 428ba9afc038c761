"""MobileViTv2 separable self-attention (counterpart of
cvnets_tpu/layers/linear_attention.py:25-80).

Layout (B, P, N, C) as in the JAX package, so the 1×1 projections are linear
layers over the trailing axis and the core takes the kernel's (BP, N, ·) views.
The core runs through the kernels' autograd Function, on the qkv projection's
output whole, where ``use_kernel`` is set and the kernels take C
(``separable_attention_eligible``); every other case takes the plain branch,
the JAX layer's non-kernel math.

With ``x_prev`` (the video models' previous frame, :46-57) q and k come
from ``x_prev`` and v from ``x``, each through its slice of the one fused
projection; the two slices are concatenated into one (BP, N, 1 + 2C) qkv
and the kernel runs on it unchanged, its dqkv split back by autograd. A
previous frame with another token count takes the plain branch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.ops.separable_attention import (
    separable_attention_eligible,
    separable_attention_qkv,
)


class LinearSelfAttention(nn.Module):
    def __init__(self, opts, embed_dim: int, attn_dropout: float = 0.0,
                 bias: bool = True) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.qkv_proj = LinearLayer(embed_dim, 1 + 2 * embed_dim, bias=bias,
                                    weight_init="conv")
        self.out_proj = LinearLayer(embed_dim, embed_dim, bias=bias,
                                    weight_init="conv")
        self.attn_dropout = nn.Dropout(attn_dropout)
        # linear_attention.py:60-62: the fused kernel runs unless switched off or
        # attention dropout is on (the kernel has no dropout)
        self.use_kernel = (getattr(opts, "model.enable_pallas_kernels", True)
                           and attn_dropout == 0.0)

    def _cross_qkv(self, x: torch.Tensor, x_prev: torch.Tensor):
        """q, k from ``x_prev`` and v from ``x`` through the projection's
        slices: one (.., 1 + 2C) tensor where the token counts agree, else
        the (q, k) and v parts."""
        d, w, b = self.embed_dim, self.qkv_proj.weight, self.qkv_proj.bias
        qk = F.linear(x_prev, w[:1 + d], None if b is None else b[:1 + d])
        v = F.linear(x, w[1 + d:], None if b is None else b[1 + d:])
        if qk.shape[:-1] == v.shape[:-1]:
            return torch.cat([qk, v], dim=-1), None
        return qk, v

    def forward(self, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = self.embed_dim
        if x_prev is None:
            qkv, value = self.qkv_proj(x), None
        else:
            qkv, value = self._cross_qkv(x, x_prev)
        if value is None and self.use_kernel and separable_attention_eligible(d):
            out = separable_attention_qkv(qkv, d)
        else:
            if value is None:
                query, key, value = qkv.split([1, d, d], dim=-1)
            else:
                query, key = qkv.split([1, d], dim=-1)
            scores = torch.softmax(query.float(), dim=-2).to(value.dtype)
            scores = self.attn_dropout(scores)
            context = (key * scores).sum(dim=-2, keepdim=True)
            out = F.relu(value) * context
        return self.out_proj(out)
