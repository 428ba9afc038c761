"""MobileViTv2 separable self-attention, spatial path (counterpart of
cvnets_tpu/layers/linear_attention.py:25-80).

Layout (B, P, N, C) as in the JAX package, so the 1×1 projections are linear
layers over the trailing axis and the core takes the kernel's (BP, N, ·) views.
The core runs through the kernels' autograd Function, on the qkv projection's
output whole, where ``use_kernel`` is set and the kernels take C
(``separable_attention_eligible``); every other case takes the plain branch,
the JAX layer's non-kernel math.
"""

from __future__ import annotations

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.embed_dim
        qkv = self.qkv_proj(x)
        if self.use_kernel and separable_attention_eligible(d):
            out = separable_attention_qkv(qkv, d)
        else:
            query, key, value = qkv.split([1, d, d], dim=-1)
            scores = torch.softmax(query.float(), dim=-2).to(value.dtype)
            scores = self.attn_dropout(scores)
            context = (key * scores).sum(dim=-2, keepdim=True)
            out = F.relu(value) * context
        return self.out_proj(out)
