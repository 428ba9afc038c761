"""MobileOne and RepLK blocks (counterpart of cvnets_tpu/modules/mobileone_block.py).

In training form a ``MobileOneBlock`` sums an identity branch (a BatchNorm,
``skip_bn``, where the shapes allow), ``num_conv_branches`` k×k conv + BN
branches (``conv_branch_<i>``) and a 1×1 conv + BN ``scale_branch``, then
squeeze-excitation and the model's activation. In inference form (built with
``inference_mode``, or after ``reparameterize``) one conv with a bias,
``reparam_conv``, takes the branches' place; ``utils/reparam_utils.py`` folds
them. ``RepLKBlock`` (FastViT's) sums a large-kernel and a small-kernel
grouped conv + BN and has no activation by default.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.activation import build_act_layer, identity
from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.normalization import BiasedVarBatchNorm2d
from cvnets_tpu_torch.modules.squeeze_excitation import SqueezeExcitation


def reparam_conv_layer(in_channels: int, out_channels: int, kernel_size: int,
                       stride: int, groups: int) -> ConvLayer2d:
    """The fused conv of an inference-form block: a conv with a bias, no norm,
    no activation (the JAX scope ``reparam_conv/conv``)."""
    return ConvLayer2d(None, in_channels, out_channels, kernel_size, stride=stride,
                       groups=groups, bias=True, use_norm=False, use_act=False)


class MobileOneBlock(nn.Module):
    def __init__(self, opts, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, use_se: bool = False,
                 use_act: bool = True, use_scale_branch: bool = True,
                 num_conv_branches: int = 1, inference_mode: bool = False) -> None:
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.groups = kernel_size, stride, groups
        self.num_conv_branches = num_conv_branches
        self.reparam_conv = self.skip_bn = self.scale_branch = None
        if inference_mode:
            self.reparam_conv = reparam_conv_layer(in_channels, out_channels, kernel_size,
                                                   stride, groups)
        else:
            if in_channels == out_channels and stride == 1:
                self.skip_bn = BiasedVarBatchNorm2d(in_channels, eps=1e-5, momentum=0.1)
            for i in range(num_conv_branches):
                setattr(self, f"conv_branch_{i}", ConvLayer2d(
                    opts, in_channels, out_channels, kernel_size, stride=stride,
                    groups=groups, use_act=False))
            if kernel_size > 1 and use_scale_branch:
                self.scale_branch = ConvLayer2d(opts, in_channels, out_channels, 1,
                                                stride=stride, groups=groups, use_act=False)
        self.se = (SqueezeExcitation(opts, out_channels, squeeze_factor=16,
                                     scale_fn_name="sigmoid") if use_se else None)
        self.act = build_act_layer(opts) if use_act else identity

    def conv_branches(self):
        return [getattr(self, f"conv_branch_{i}") for i in range(self.num_conv_branches)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reparam_conv is not None:
            y = self.reparam_conv(x)
        else:
            # the JAX block's order of summation
            y = self.skip_bn(x) if self.skip_bn is not None else 0.0
            for branch in self.conv_branches():
                y = y + branch(x)
            if self.scale_branch is not None:
                y = y + self.scale_branch(x)
        if self.se is not None:
            y = self.se(y)
        return self.act(y)

    @torch.no_grad()
    def reparameterize(self) -> None:
        """Fold the branches into ``reparam_conv`` (in float64) and drop them."""
        from cvnets_tpu_torch.utils.reparam_utils import fold_mobileone_block

        if self.reparam_conv is not None:
            return
        weight, bias = fold_mobileone_block(self)
        conv = reparam_conv_layer(self.in_channels, self.out_channels, self.kernel_size,
                                  self.stride, self.groups).to(weight.device)
        conv.conv.weight.copy_(weight)
        conv.conv.bias.copy_(bias)
        for i in range(self.num_conv_branches):
            delattr(self, f"conv_branch_{i}")
        self.num_conv_branches = 0
        self.skip_bn = self.scale_branch = None
        self.reparam_conv = conv


class RepLKBlock(nn.Module):
    """Grouped large-kernel conv + BN (``lk_conv``) plus a small-kernel one
    (``sk_conv``), or their fold ``reparam_conv`` (mobileone_block.py:72-112).
    ``use_act`` is off by default: the reference computes the activation and
    discards it, and FastViT's checkpoints were trained so."""

    def __init__(self, opts, channels: int, out_channels: Optional[int] = None,
                 kernel_size: int = 7, small_kernel: Optional[int] = 3, stride: int = 1,
                 groups: Optional[int] = None, use_act: bool = False,
                 inference_mode: bool = False) -> None:
        super().__init__()
        out_channels = out_channels or channels
        groups = groups or channels
        self.in_channels, self.out_channels = channels, out_channels
        self.kernel_size, self.stride, self.groups = kernel_size, stride, groups
        self.reparam_conv = self.lk_conv = self.sk_conv = None
        if inference_mode:
            self.reparam_conv = reparam_conv_layer(channels, out_channels, kernel_size,
                                                   stride, groups)
        else:
            self.lk_conv = ConvLayer2d(opts, channels, out_channels, kernel_size,
                                       stride=stride, groups=groups, use_act=False)
            if small_kernel is not None:
                self.sk_conv = ConvLayer2d(opts, channels, out_channels, small_kernel,
                                           stride=stride, groups=groups, use_act=False)
        self.act = build_act_layer(opts) if use_act else identity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reparam_conv is not None:
            return self.act(self.reparam_conv(x))
        y = self.lk_conv(x)
        if self.sk_conv is not None:
            y = y + self.sk_conv(x)
        return self.act(y)

    @torch.no_grad()
    def reparameterize(self) -> None:
        from cvnets_tpu_torch.utils.reparam_utils import fold_replk_block

        if self.reparam_conv is not None:
            return
        weight, bias = fold_replk_block(self)
        conv = reparam_conv_layer(self.in_channels, self.out_channels, self.kernel_size,
                                  self.stride, self.groups).to(weight.device)
        conv.conv.weight.copy_(weight)
        conv.conv.bias.copy_(bias)
        self.lk_conv = self.sk_conv = None
        self.reparam_conv = conv
