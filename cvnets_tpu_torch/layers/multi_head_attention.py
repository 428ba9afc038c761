"""Multi-head attention (counterpart of cvnets_tpu/layers/multi_head_attention.py).

One fused ``qkv_proj`` (E → 3E) and ``out_proj``, on (B, S, E) tokens. The
layer takes the fused kernel (ops/mha_attention.py) when the JAX layer does
(:77-101): no ``attn_mask``, as many queries as keys, no attention dropout
in training, and a shape ``fused_attention_eligible`` accepts (on the card
also an S > 512 that no TPU kernel blocks, which JAX sends to its einsum
route: the CUDA kernels tile a ragged S); key padding
then enters as an additive -1e30 mask. Otherwise it runs the einsum route
(:106-120) with a float32 softmax, where key padding fills ``finfo.min``,
inside a ``torch.profiler`` range named ``EINSUM_ROUTE``, so that a profile
can sum the route's kernels (its backward's through the autograd sequence
numbers of the ops in the range).

Under ``--dev.sequence-parallel`` the layer takes ring attention
(``parallel/ring_attention.py``, the JAX layer's :87-100) in the fused
route's place when the model axis M > 1 divides S (``ring_attention_eligible``),
with the same conditions: no ``attn_mask``, as many queries as keys, no
attention dropout in training. Otherwise, M = 1 among them, it keeps its
local route, as JAX's does.

Under ``--common.int8-inference`` both projections take the int8 forward
(``quantization.quant_linear``, the JAX ``quant_dense``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.profiler import record_function

from cvnets_tpu_torch.ops.mha_attention import fused_attention_eligible, fused_mha_attention
from cvnets_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_eligible
from cvnets_tpu_torch.quantization import quant_linear

EINSUM_ROUTE = "mha_einsum_route"


class MultiHeadAttention(nn.Module):
    def __init__(self, opts, embed_dim: int, num_heads: int, attn_dropout: float = 0.0,
                 bias: bool = True) -> None:
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} must be divisible by num_heads {num_heads}")
        self.sequence_parallel = bool(getattr(opts, "dev.sequence_parallel", False))
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.qkv_proj = quant_linear(opts, embed_dim, 3 * embed_dim, bias=bias)
        self.out_proj = quant_linear(opts, embed_dim, embed_dim, bias=bias)
        self.attn_dropout = nn.Dropout(attn_dropout)
        # False sends every call down the einsum route (a kernel/plain A/B)
        self.use_kernel = True

    def forward(self, x_q: torch.Tensor, x_kv: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        d, h = self.embed_dim, self.num_heads
        hd = d // h
        if x_kv is None or x_kv is x_q:
            q, k, v = self.qkv_proj(x_q).chunk(3, dim=-1)
        else:
            q = self.qkv_proj(x_q)[..., :d]
            kv = self.qkv_proj(x_kv)
            k, v = kv[..., d:2 * d], kv[..., 2 * d:]

        b, nq, _ = q.shape
        nk = k.shape[1]
        scale = hd ** -0.5
        fused = (attn_mask is None and nq == nk
                 and (self.attn_dropout.p == 0 or not self.training))
        km = None
        if fused and key_padding_mask is not None:
            km = torch.where(key_padding_mask, -1e30, 0.0)
        if fused and self.sequence_parallel and ring_attention_eligible(nq):
            return self.out_proj(ring_attention(q * scale, k, v, h, km))
        if (fused and self.use_kernel
                and fused_attention_eligible(nq, d, h, q.element_size(), q.is_cuda)):
            return self.out_proj(fused_mha_attention(q * scale, k, v, h, km))

        with record_function(EINSUM_ROUTE):
            q = q.reshape(b, nq, h, hd)
            k = k.reshape(b, nk, h, hd)
            v = v.reshape(b, nk, h, hd)
            logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
            if attn_mask is not None:
                logits = logits + attn_mask
            if key_padding_mask is not None:
                logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                            torch.finfo(logits.dtype).min)
            attn = self.attn_dropout(torch.softmax(logits.float(), dim=-1).to(logits.dtype))
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, nq, d)
        return self.out_proj(out)
