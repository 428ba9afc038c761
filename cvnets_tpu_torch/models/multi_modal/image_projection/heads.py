"""Image projection heads for CLIP (counterpart of
cvnets_tpu/models/multi_modal/image_projection/heads.py).

Each maps the image encoder's features to the joint space through a
``proj`` matrix (in, out), as the flax parameter is laid out, and ends in an
L2 normalization whose norm is computed in float32:

* ``simple_projection_nc2nc``: (B, C) → (B, out);
* ``global_pool_nchw2nc``: the mean over H and W of a (B, C, H, W) input,
  then the projection; a (B, C) input (the ViT's class embedding) is only
  projected, as in the JAX head (heads.py:48-49);
* ``attention_pool_nchw2nc``: CLIP-ResNet's attention pooling: the mean
  token first, then the H·W tokens, plus a learnable positional table, and
  a multi-head attention of the mean token over all of them (8 heads). The
  flax table is sized at its first call; here its length comes from the
  sampler's crop size and a stride-32 encoder, and another token count raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.init_utils import init_tensor
from cvnets_tpu_torch.layers.multi_head_attention import MultiHeadAttention
from cvnets_tpu_torch.models.multi_modal.image_projection import (
    IMAGE_PROJECTION_HEAD_REGISTRY,
)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x`` over its last axis's norm, the norm taken in float32 and cast to x's dtype."""
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True).to(x.dtype)


class _ProjectionHead(nn.Module):
    def __init__(self, opts, in_dim: int, out_dim: int) -> None:
        super().__init__()
        self.in_dim = in_dim
        self.proj = nn.Parameter(torch.empty(in_dim, out_dim))

    def init_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_tensor(self.proj, "normal", self.in_dim ** -0.5, generator)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(x @ self.proj)


@IMAGE_PROJECTION_HEAD_REGISTRY.register(name="simple_projection_nc2nc")
class SimpleImageProjectionHead(_ProjectionHead):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(x)


@IMAGE_PROJECTION_HEAD_REGISTRY.register(name="global_pool_nchw2nc")
class GlobalPool2D(_ProjectionHead):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(x.mean(dim=(2, 3)) if x.dim() == 4 else x)


def _stride32_side(n: int) -> int:
    for _ in range(5):  # five stride-2 stages, each ceil(n / 2)
        n = (n + 1) // 2
    return n


@IMAGE_PROJECTION_HEAD_REGISTRY.register(name="attention_pool_nchw2nc")
class AttentionPool2dHead(_ProjectionHead):
    def __init__(self, opts, in_dim: int, out_dim: int, num_heads: int = 8) -> None:
        super().__init__(opts, in_dim, out_dim)
        side_h = _stride32_side(getattr(opts, "sampler.bs.crop_size_height", 224) or 224)
        side_w = _stride32_side(getattr(opts, "sampler.bs.crop_size_width", 224) or 224)
        self.pos_embed = nn.Parameter(torch.empty(side_h * side_w + 1, in_dim))
        self.attn = MultiHeadAttention(opts, in_dim, num_heads)

    def init_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        super().init_own_parameters(generator)
        init_tensor(self.pos_embed, "normal", self.in_dim ** -0.5, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = x.flatten(2).transpose(1, 2)  # (B, H·W, C), row-major as the NHWC reshape
        if tokens.shape[1] + 1 != self.pos_embed.shape[0]:
            raise ValueError(f"attention_pool_nchw2nc: {tokens.shape[1]} tokens, but its "
                             f"positional table was sized for {self.pos_embed.shape[0] - 1} "
                             "from the sampler's crop size")
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.pos_embed[None].to(tokens.dtype)
        return self.project(self.attn(tokens[:, :1], x_kv=tokens)[:, 0])
