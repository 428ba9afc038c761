"""Branch folding of MobileOne and RepLK blocks (counterpart of
cvnets_tpu/utils/reparam_utils.py, which folds flax trees on the host): at
inference the parallel training branches become one conv with a bias,

    W = Σ_b γ_b / σ_b · pad(W_b),    b = Σ_b β_b − γ_b μ_b / σ_b,

with σ_b = sqrt(var_b + eps) of each branch's BN, a 1×1 kernel padded to the
centre of k×k, and the identity branch a centred (grouped) identity kernel.
Computed in float64, as the JAX package's numpy code is; kernels are torch's
(O, I/groups, kh, kw).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _fuse_conv_bn(weight: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(OIHW kernel, its BN) -> (folded kernel, folded bias), float64."""
    t = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
    return (weight.double() * t.view(-1, 1, 1, 1),
            bn.bias.double() - bn.running_mean.double() * t)


def _pad_to_k(weight: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad an (O, I, kh, kw) kernel to (O, I, k, k), centred."""
    kh, kw = weight.shape[2:]
    ph, pw = (k - kh) // 2, (k - kw) // 2
    return F.pad(weight, (pw, k - kw - pw, ph, k - kh - ph))


def _identity_kernel(k: int, in_per_group: int, out_channels: int,
                     device: torch.device) -> torch.Tensor:
    """Centred identity (O, I/groups, k, k) kernel of the BN skip branch."""
    ker = torch.zeros(out_channels, in_per_group, k, k, dtype=torch.float64, device=device)
    o = torch.arange(out_channels, device=device)
    ker[o, o % in_per_group, k // 2, k // 2] = 1.0
    return ker


def fold_mobileone_block(block) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kernel, bias) of a training-form ``MobileOneBlock``, in the order of
    ``reparameterize_mobileone_block`` (reparam_utils.py:61-99)."""
    parts = [_fuse_conv_bn(b.conv.weight, b.norm) for b in block.conv_branches()]
    if block.scale_branch is not None:
        w, b = _fuse_conv_bn(block.scale_branch.conv.weight, block.scale_branch.norm)
        parts.append((_pad_to_k(w, block.kernel_size), b))
    if block.skip_bn is not None:
        ref = parts[0][0]
        ident = _identity_kernel(block.kernel_size, ref.shape[1], ref.shape[0], ref.device)
        parts.append(_fuse_conv_bn(ident, block.skip_bn))
    weight, bias = parts[0]
    for w, b in parts[1:]:
        weight, bias = weight + w, bias + b
    return weight.float(), bias.float()


def fold_replk_block(block) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kernel, bias) of a training-form ``RepLKBlock`` (reparam_utils.py:118-128)."""
    weight, bias = _fuse_conv_bn(block.lk_conv.conv.weight, block.lk_conv.norm)
    if block.sk_conv is not None:
        w, b = _fuse_conv_bn(block.sk_conv.conv.weight, block.sk_conv.norm)
        weight, bias = weight + _pad_to_k(w, block.kernel_size), bias + b
    return weight.float(), bias.float()


def reparameterize_model(model: nn.Module) -> nn.Module:
    """Fold every MobileOne and RepLK block of ``model`` in place, the
    counterpart of ``get_exportable_params``; returns ``model``. The folds
    read the BN running statistics, so the model's eval forward is unchanged
    up to float rounding."""
    from cvnets_tpu_torch.modules.mobileone_block import MobileOneBlock, RepLKBlock

    for m in list(model.modules()):
        if isinstance(m, (MobileOneBlock, RepLKBlock)):
            m.reparameterize()
    return model
