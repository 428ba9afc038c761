"""FastViT modules (counterpart of cvnets_tpu/modules/fastvit.py): ``RepMixer``,
``ConvFFN``, ``RepCPE``, ``AttentionBlock``, ``RepMixerBlock`` and
``PatchEmbed``, built on the port's ``MobileOneBlock`` and ``RepLKBlock``.

``inference_mode`` builds the structures the JAX package builds with it: a
``RepMixer`` becomes one depthwise conv with a bias (``reparam_conv``, and no
layer scale), a ``RepCPE`` drops its identity, and the MobileOne and RepLK
blocks take their folded form. No fold beyond the JAX package's is added.
``AttentionBlock`` is the JAX package's einsum attention over the H·W tokens
(a plain product: its head dim, 32, is one the MHA kernel takes, but the JAX
block never reaches the Pallas kernel, and neither does this one). Its
``norm`` is a stock flax BatchNorm there, hence ``BiasedVarBatchNorm2d``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.random_layers import StochasticDepth
from cvnets_tpu_torch.modules.mobileone_block import (
    BiasedVarBatchNorm2d,
    MobileOneBlock,
    RepLKBlock,
)
from cvnets_tpu_torch.quantization import quant_linear


def layer_scale(dim: int, init_value: float) -> nn.Parameter:
    return nn.Parameter(torch.full((dim,), float(init_value)))


def _scaled(scale, y: torch.Tensor) -> torch.Tensor:
    """``scale`` (C,) times NCHW ``y``, in ``y``'s dtype, as the JAX blocks cast it."""
    return y if scale is None else scale.to(y.dtype).view(1, -1, 1, 1) * y


class RepMixer(nn.Module):
    """x + layer_scale · (mixer(x) - norm(x)): two depthwise MobileOne blocks,
    ``norm`` a BatchNorm skip alone."""

    def __init__(self, opts, dim: int, kernel_size: int = 3, use_layer_scale: bool = True,
                 layer_scale_init_value: float = 1e-5, inference_mode: bool = False) -> None:
        super().__init__()
        self.layer_scale = self.reparam_conv = self.norm = self.mixer = None
        if inference_mode:
            self.reparam_conv = ConvLayer2d(opts, dim, dim, kernel_size, groups=dim, bias=True,
                                            use_norm=False, use_act=False)
            return
        if use_layer_scale:
            self.layer_scale = layer_scale(dim, layer_scale_init_value)
        self.norm = MobileOneBlock(opts, dim, dim, kernel_size, groups=dim, use_act=False,
                                   num_conv_branches=0, use_scale_branch=False)
        self.mixer = MobileOneBlock(opts, dim, dim, kernel_size, groups=dim, use_act=False,
                                    num_conv_branches=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reparam_conv is not None:
            return self.reparam_conv(x)
        norm, mix = self.norm(x), self.mixer(x)
        if self.layer_scale is None:
            return x + mix - norm
        return x + _scaled(self.layer_scale, mix - norm)


class ConvFFN(nn.Module):
    """7×7 depthwise conv + BN → 1×1 expand → activation → 1×1 project."""

    def __init__(self, opts, dim: int, hidden_dim: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.conv_dw = ConvLayer2d(opts, dim, dim, 7, groups=dim, use_act=False)
        self.fc1 = ConvLayer2d(opts, dim, hidden_dim, 1, bias=True, use_norm=False,
                               use_act=False)
        self.act = build_act_layer(opts)
        self.fc2 = ConvLayer2d(opts, hidden_dim, dim, 1, bias=True, use_norm=False,
                               use_act=False)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dropout(self.act(self.fc1(self.conv_dw(x))))
        return self.dropout(self.fc2(y))


class RepCPE(nn.Module):
    """Conditional positional encoding: a depthwise conv with a bias, plus the
    input (the input is left out in inference mode, as in the JAX block)."""

    def __init__(self, opts, dim: int, spatial_shape=(7, 7),
                 inference_mode: bool = False) -> None:
        super().__init__()
        self.inference_mode = inference_mode
        self.pe_conv = ConvLayer2d(opts, dim, dim, spatial_shape[0], groups=dim, bias=True,
                                   use_norm=False, use_act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pe_conv(x)
        return y if self.inference_mode else y + x


class AttentionBlock(nn.Module):
    """BN → multi-head attention over the H·W tokens → layer scale → residual,
    then a ConvFFN residual."""

    def __init__(self, opts, dim: int, mlp_ratio: float = 4.0, num_heads: int = 8,
                 dropout: float = 0.0, stochastic_depth_prob: float = 0.0,
                 use_layer_scale: bool = True, layer_scale_init_value: float = 1e-5) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.layer_scale_1 = self.layer_scale_2 = None
        if use_layer_scale:
            self.layer_scale_1 = layer_scale(dim, layer_scale_init_value)
            self.layer_scale_2 = layer_scale(dim, layer_scale_init_value)
        self.norm = BiasedVarBatchNorm2d(dim, eps=1e-5, momentum=0.1)
        self.qkv = quant_linear(opts, dim, 3 * dim)
        self.proj = quant_linear(opts, dim, dim)
        self.ffn = ConvFFN(opts, dim, int(dim * mlp_ratio), dropout=dropout)
        self.stochastic_depth = StochasticDepth(stochastic_depth_prob)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hd = c // self.num_heads
        tokens = self.norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.qkv(tokens).reshape(b, h * w, 3, self.num_heads, hd).unbind(2)
        logits = torch.einsum("bnhd,bmhd->bhnm", q * hd ** -0.5, k)
        attn = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, h * w, c)
        return self.proj(out).transpose(1, 2).reshape(b, c, h, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.stochastic_depth(_scaled(self.layer_scale_1, self.attention(x)))
        return x + self.stochastic_depth(_scaled(self.layer_scale_2, self.ffn(x)))


class RepMixerBlock(nn.Module):
    """RepMixer token mixing, then a ConvFFN residual with its layer scale."""

    def __init__(self, opts, dim: int, kernel_size: int = 3, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, stochastic_depth_prob: float = 0.0,
                 use_layer_scale: bool = True, layer_scale_init_value: float = 1e-5,
                 inference_mode: bool = False) -> None:
        super().__init__()
        self.layer_scale = (layer_scale(dim, layer_scale_init_value) if use_layer_scale
                            else None)
        self.token_mixer = RepMixer(opts, dim, kernel_size, use_layer_scale=use_layer_scale,
                                    layer_scale_init_value=layer_scale_init_value,
                                    inference_mode=inference_mode)
        self.ffn = ConvFFN(opts, dim, int(dim * mlp_ratio), dropout=dropout)
        self.stochastic_depth = StochasticDepth(stochastic_depth_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.token_mixer(x)
        return x + self.stochastic_depth(_scaled(self.layer_scale, self.ffn(x)))


class PatchEmbed(nn.Module):
    """The downsampler: a grouped RepLK conv (stride and channel expansion at
    once), then a 1×1 MobileOne block."""

    def __init__(self, opts, in_channels: int, embed_dim: int, patch_size: int = 7,
                 stride: int = 2, inference_mode: bool = False) -> None:
        super().__init__()
        self.replk = RepLKBlock(opts, in_channels, embed_dim, kernel_size=patch_size,
                                small_kernel=3, stride=stride, groups=in_channels,
                                inference_mode=inference_mode)
        self.proj = MobileOneBlock(opts, embed_dim, embed_dim, kernel_size=1,
                                   num_conv_branches=1, inference_mode=inference_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.replk(x))
