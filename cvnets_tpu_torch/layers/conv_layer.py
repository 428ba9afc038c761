"""Conv + Norm + Act, the depthwise-separable conv and the block transposed
conv (counterpart of cvnets_tpu/layers/conv_layer.py).

NCHW layout; padding ``((kernel - 1) // 2) * dilation`` on each side, as in the JAX
package and the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.layers.normalization import LayerNorm2d, get_normalization_layer


class ConvLayer2d(nn.Module):
    def __init__(self, opts, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 groups: int = 1, bias: bool = False, use_norm: bool = True,
                 use_act: bool = True, act_name: Optional[str] = None,
                 norm_name: Optional[str] = None) -> None:
        super().__init__()
        from cvnets_tpu_torch.quantization import Int8Conv, int8_mode_of

        # --common.int8-inference swaps a dense conv only (conv_layer.py:73-76 in
        # the JAX package): a depthwise conv's bytes and products are too few
        mode = int8_mode_of(opts) if groups == 1 else None
        conv_cls, extra = (nn.Conv2d, {}) if mode is None else (Int8Conv, {"mode": mode})
        self.conv = conv_cls(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=((kernel_size - 1) // 2) * dilation, dilation=dilation,
            groups=groups,
            bias=self._effective_bias(opts, bias, use_norm, norm_name), **extra)
        self.norm = (get_normalization_layer(opts, out_channels, norm_name)
                     if use_norm else None)
        self.act = build_act_layer(opts, act_name) if use_act else None

    @staticmethod
    def _effective_bias(opts, bias: bool, use_norm: bool,
                        norm_name: Optional[str]) -> bool:
        """Reference quirk (conv_layer.py:47-55 in the JAX package): a conv
        followed by a LayerNorm-family norm keeps its bias even if ``bias=False``."""
        if not use_norm or bias:
            return bias
        nt = (norm_name or getattr(opts, "model.normalization.name", "batch_norm")
              or "batch_norm").lower()
        return nt in ("layer_norm", "layer_norm_2d", "layer_norm_fp32")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if isinstance(self.norm, (LayerNorm2d, nn.LayerNorm)):  # channels-last norms
            x = self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        elif self.norm is not None:
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x


class SeparableConv2d(nn.Module):
    """Depthwise k×k conv + norm, then a pointwise 1×1 ConvLayer2d
    (conv_layer.py:136-176): ``dw_conv`` and ``pw_conv``."""

    def __init__(self, opts, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 use_norm: bool = True, use_act: bool = True, bias: bool = False,
                 act_name: Optional[str] = None) -> None:
        super().__init__()
        self.dw_conv = ConvLayer2d(opts, in_channels, in_channels, kernel_size,
                                   stride=stride, dilation=dilation, groups=in_channels,
                                   use_act=False)
        self.pw_conv = ConvLayer2d(opts, in_channels, out_channels, 1, bias=bias,
                                   use_norm=use_norm, use_act=use_act, act_name=act_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw_conv(self.dw_conv(x))


class BlockConvTranspose(nn.Module):
    """Transposed conv with ``kernel == stride`` (non-overlapping output blocks;
    conv_layer.py:178-210 in the JAX package): ``out[·, o, s·i+di, s·j+dj] =
    Σ_c x[·, c, i, j] · K[di, dj, c, o]`` with K the flax kernel
    (kh, kw, in, out) read with its taps flipped inside each block
    (``kernel[::-1, ::-1]``), which is where flax's transposed conv puts them.
    The weight is held as a conv's (out, in, kh, kw), the layout
    ``utils.jax_params`` gives every 4-D ``kernel``; the forward flips the taps
    and runs ``F.conv_transpose2d``, whose weight is (in, out, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 bias: bool = True) -> None:
        super().__init__()
        self.stride = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight.flip(2, 3).transpose(0, 1)
        return F.conv_transpose2d(x, weight, self.bias, stride=self.stride)


class TransposeConvLayer2d(nn.Module):
    """Transposed conv (+ norm + act) (conv_layer.py:213-256): ``conv`` a
    ``BlockConvTranspose``, ``norm`` the options' normalization. The JAX layer's
    other branch, a SAME-padded ``nn.ConvTranspose`` where kernel and stride
    differ, runs on no shipped configuration and raises here."""

    def __init__(self, opts, in_channels: int, out_channels: int, kernel_size: int = 2,
                 stride: int = 2, bias: bool = False, use_norm: bool = True,
                 use_act: bool = True, act_name: Optional[str] = None) -> None:
        super().__init__()
        if kernel_size != stride:
            raise NotImplementedError(
                f"TransposeConvLayer2d: kernel {kernel_size} ≠ stride {stride} (flax's "
                "SAME-padded ConvTranspose) is not ported; kernel == stride is")
        self.conv = BlockConvTranspose(in_channels, out_channels, kernel_size, bias=bias)
        self.norm = get_normalization_layer(opts, out_channels) if use_norm else None
        self.act = build_act_layer(opts, act_name) if use_act else None

    forward = ConvLayer2d.forward
