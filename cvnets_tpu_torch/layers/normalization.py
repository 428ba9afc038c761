"""Normalization layers (counterpart of cvnets_tpu/layers/normalization.py).

* ``batch_norm`` is ``nn.BatchNorm2d`` with the yaml's momentum used as it is: the
  configs carry the torch convention, and torch already tracks the Bessel-corrected
  running variance that the JAX package's ``TorchBatchNorm`` imitates.
* ``layer_norm_2d`` is GroupNorm with ONE group (normalization.py:190-193):
  statistics over channels and space jointly, affine per channel. It is applied to
  channels-last tensors, the layout of MobileViTv2's (B, P, N, C) patches.
* ``layer_norm`` is a LayerNorm over the trailing axis only, with the caller's
  eps (normalization.py:185-188); ViT's (B, S, E) tokens take it.
* ``batch_norm_1d`` and ``batch_norm_3d`` are ``nn.BatchNorm1d`` and
  ``nn.BatchNorm3d`` (the JAX package's one BN over the trailing axis, for
  torch's channels-second tensors); ``sync_batch_norm_fp32`` and
  ``layer_norm_fp32`` compute and return float32 (JAX's ``dtype=jnp.float32``);
  ``group_norm`` (``model.normalization.groups`` groups) and ``instance_norm``
  / ``instance_norm_2d`` (one channel a group) are a GroupNorm in float32 that
  returns float32, as flax's GroupNorm without a dtype promotes a bf16 input
  with its float32 scale.
* ``AdjustBatchNormMomentum`` anneals the BN momentum over training; the train
  step writes its value into every BatchNorm module before the forward.
* Under ``model.normalization.frozen`` (set by ``get_model`` from
  ``--model.<category>.freeze-batch-norm``) every batch norm is a frozen one
  (normalization.py:125): it normalizes with its running statistics in train
  mode too and never updates them; ``build_optimizer`` leaves the norms'
  scales and biases out (``NORM_PARAM_FREEZE_REGEX``).

In a process group of more than one rank (``parallel``) every BatchNorm in
train mode, ``batch_norm`` as well as ``sync_batch_norm``, normalizes with the
global batch's statistics, as the JAX package's jit over a data-sharded batch
computes them (the reference syncs ``sync_batch_norm`` only):
``_SyncedBatchNorm`` gathers each rank's (count, mean, Σ(x − mean)²) a
channel in its forward and combines them (Chan's formula: the global mean
and biased variance, as flax's BatchNorm takes them, without the
cancellation of E[x²] − E[x]² in float32, which left the logits of a micro
MobileViTv2 1.2e-4 from JAX's where one process's BN stays within 1e-4),
all-reduces (Σ dy, Σ dy·x̂) in its backward, and updates the running
statistics from the global ones. Frozen BN, eval mode and one process do
not sync.
(``torch.nn.SyncBatchNorm`` takes CUDA tensors only, so the CPU tests could
not hold it against JAX.)

Both compute in float32 and return the compute dtype, as JAX's do with
``dtype=compute_dtype(opts)``: the autocast dtype under autocast, else the
input's dtype. Swin builds plain ``nn.LayerNorm``s, which stay float32 as its
JAX norms (no dtype) do.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch import parallel
from cvnets_tpu_torch.utils import logger

BATCH_NORMS = ("batch_norm", "batch_norm_2d", "sync_batch_norm")

# a normalization layer's scale or bias by its name, the JAX package's regex on
# flax paths (normalization.py:34-37) with torch's separators and leaf names:
# every norm attribute's name holds "norm"
NORM_PARAM_FREEZE_REGEX = r"(^|\.)[^.]*norm[^.]*\.(weight|bias)$"
SUPPORTED_NORM_FNS = BATCH_NORMS + (
    "batch_norm_1d", "batch_norm_3d", "sync_batch_norm_fp32", "layer_norm", "layer_norm_2d",
    "layer_norm_fp32", "group_norm", "instance_norm", "instance_norm_2d", "identity")


def _output_dtype(x: torch.Tensor) -> torch.dtype:
    """The autocast dtype of x's device type where autocast is on there, else
    x's dtype."""
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in float32 that returns the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(_output_dtype(x))


class LayerNormFP32(LayerNorm):
    """``LayerNorm`` that returns float32 whatever the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class _SyncedBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of a process group."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked,
                momentum, eps: float, bessel: bool):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        xf = x.float()
        var_r, mean_r = torch.var_mean(xf, dims, correction=0)
        n_r = x.numel() // c
        parts = torch.stack(parallel.all_gather(
            torch.cat([mean_r, var_r * n_r, xf.new_full((1,), n_r)])))  # (ranks, 2C + 1)
        counts = parts[:, 2 * c:]
        n = counts.sum()
        mean = (parts[:, :c] * counts).sum(0) / n
        # Chan's combination of the ranks' (count, mean, Σ(x - mean)²)
        var = (parts[:, c:2 * c].sum(0) + (counts * (parts[:, :c] - mean) ** 2).sum(0)) / n
        invstd = torch.rsqrt(var + eps)
        if running_mean is not None:
            num_batches_tracked.add_(1)
            m = 1.0 / float(num_batches_tracked) if momentum is None else momentum
            unbiased = var * n / (n - 1).clamp(min=1.0) if bessel else var
            running_mean.mul_(1 - m).add_(mean, alpha=m)
            running_var.mul_(1 - m).add_(unbiased, alpha=m)
        y = (xf - mean.view(shape)) * invstd.view(shape)
        if weight is not None:
            y = y * weight.float().view(shape) + bias.float().view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        dy = g.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sum_dy, sum_dy_xhat = dy.sum(dims), (dy * xhat).sum(dims)
        red = parallel.all_reduce_(torch.cat([sum_dy, sum_dy_xhat]))
        scale = invstd if weight is None else invstd * weight.float()
        dx = (dy - (red[:c] / n).view(shape) - xhat * (red[c:] / n).view(shape)) \
            * scale.view(shape)
        dw = db = None
        if weight is not None:
            dw, db = sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype)
        return dx.to(x.dtype), dw, db, None, None, None, None, None, None


def _sync_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                     bessel: bool = True) -> torch.Tensor:
    tracking = bn.track_running_stats and bn.running_mean is not None
    return _SyncedBatchNorm.apply(
        x, bn.weight, bn.bias, bn.running_mean if tracking else None,
        bn.running_var if tracking else None, bn.num_batches_tracked if tracking else None,
        bn.momentum, bn.eps, bessel)


class _GlobalBatchStats:
    """A BatchNorm that takes the global batch's statistics in train mode in a
    process group of more than one rank."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and parallel.data_size() > 1:
            self._check_input_dim(x)
            return _sync_batch_norm(self, x)
        return super().forward(x)


class BatchNorm1d(_GlobalBatchStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_GlobalBatchStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_GlobalBatchStats, nn.BatchNorm3d):
    pass


class BatchNorm2dFP32(BatchNorm2d):
    """``BatchNorm2d`` on a float32 copy of its input: float32 out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class BiasedVarBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance tracks the biased batch
    variance: a stock flax ``nn.BatchNorm`` in the JAX package (MobileOne's
    skip branch, mobileone_block.py:43-46, and FastViT's), not its
    torch-convention BN. The forward and its gradient are BatchNorm's own, in
    one pass over the batch; in a process group, the synced one's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if parallel.data_size() > 1:
            return _sync_batch_norm(self, x, bessel=False)
        m = self.momentum
        # the backward keeps the running variance it was given: a copy, C floats
        running_var = self.running_var.clone()
        out, _, invstd = torch.native_batch_norm(x, self.weight, self.bias, self.running_mean,
                                                 running_var, True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # the update took m · var · n / (n - 1): take m · var / (n - 1) back
            var = invstd.pow(-2).sub_(self.eps)
            self.running_var.copy_(running_var.sub(var, alpha=m / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)
        return out


class _Frozen:
    """Normalizes with the running statistics, in train mode too, and never
    updates them (nor the batch counter)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class FrozenBatchNorm1d(_Frozen, nn.BatchNorm1d):
    pass


class FrozenBatchNorm2d(_Frozen, nn.BatchNorm2d):
    pass


class FrozenBatchNorm3d(_Frozen, nn.BatchNorm3d):
    pass


class FrozenBatchNorm2dFP32(FrozenBatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` in float32 that returns float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


class LayerNorm2d(nn.Module):
    """GroupNorm(num_groups=1) for a channels-last tensor (B, ..., C): one mean
    and variance over every non-batch element, then a per-channel affine, in
    float32; returns the compute dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[1:], eps=self.eps) * self.weight + self.bias
        return y.to(_output_dtype(x))


def get_normalization_layer(opts, num_features: int,
                            norm_type: Optional[str] = None,
                            eps: float = 1e-5,
                            num_groups: Optional[int] = None) -> Optional[nn.Module]:
    if norm_type is None:
        norm_type = getattr(opts, "model.normalization.name", "batch_norm")
    norm_type = (norm_type or "batch_norm").lower()
    momentum = getattr(opts, "model.normalization.momentum", 0.1)
    momentum = 0.1 if momentum is None else momentum
    # every BN syncs in a process group (see the docstring), sync_batch_norm too
    if getattr(opts, "model.normalization.frozen", False):
        batch_norm = {**dict.fromkeys(BATCH_NORMS, FrozenBatchNorm2d),
                      "batch_norm_1d": FrozenBatchNorm1d, "batch_norm_3d": FrozenBatchNorm3d,
                      "sync_batch_norm_fp32": FrozenBatchNorm2dFP32}.get(norm_type)
    else:
        batch_norm = {**dict.fromkeys(BATCH_NORMS, BatchNorm2d),
                      "batch_norm_1d": BatchNorm1d, "batch_norm_3d": BatchNorm3d,
                      "sync_batch_norm_fp32": BatchNorm2dFP32}.get(norm_type)
    if batch_norm is not None:
        return batch_norm(num_features, eps=eps, momentum=momentum)
    if norm_type == "layer_norm":
        return LayerNorm(num_features, eps=eps)
    if norm_type == "layer_norm_2d":
        return LayerNorm2d(num_features, eps=eps)
    if norm_type == "layer_norm_fp32":
        return LayerNormFP32(num_features, eps=eps)
    if norm_type == "group_norm":
        if num_groups is None:
            num_groups = getattr(opts, "model.normalization.groups", 32)
        return GroupNorm(int(num_groups), num_features, eps=eps)
    if norm_type in ("instance_norm", "instance_norm_2d"):
        return GroupNorm(num_features, num_features, eps=eps)
    if norm_type == "identity":
        return None
    logger.error(f"Unsupported norm layer `{norm_type}`. Supported: {SUPPORTED_NORM_FNS}")


class AdjustBatchNormMomentum:
    """The torch-convention BN momentum of an iteration, annealed from
    ``model.normalization.momentum`` to ``final_momentum_value`` by a cosine or
    a line over the epochs, or over the iterations after warmup; rounded to 6
    places (cvnets_tpu/layers/normalization.py:209-253)."""

    round_places = 6

    def __init__(self, opts) -> None:
        self.is_iteration_based = getattr(opts, "scheduler.is_iteration_based", True)
        self.warmup_iterations = getattr(opts, "scheduler.warmup_iterations", 0) or 0
        if self.is_iteration_based:
            self.max_steps = getattr(opts, "scheduler.max_iterations", 10000) or 10000
            self.max_steps -= self.warmup_iterations
        else:
            self.max_steps = getattr(opts, "scheduler.max_epochs", 100) or 100
        self.momentum = getattr(opts, "model.normalization.momentum", 0.1) or 0.1
        self.min_momentum = getattr(
            opts, "model.normalization.adjust_bn_momentum.final_momentum_value", 1e-6)
        self.anneal_type = getattr(
            opts, "model.normalization.adjust_bn_momentum.anneal_type", "cosine")
        if self.anneal_type not in ("cosine", "linear"):
            logger.error(f"Unsupported BN momentum anneal type {self.anneal_type}")

    def get_momentum(self, epoch: int, iteration: int) -> float:
        step = iteration - self.warmup_iterations if self.is_iteration_based else epoch
        step = max(0, min(step, self.max_steps))
        if self.anneal_type == "cosine":
            m = self.min_momentum + 0.5 * (self.momentum - self.min_momentum) * (
                1 + math.cos(math.pi * step / self.max_steps))
        else:
            m = self.momentum - (self.momentum - self.min_momentum) * step / self.max_steps
        return round(max(0.0, m), self.round_places)


def arguments_norm_layers(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Normalization layer arguments")
    group.add_argument("--model.normalization.name", type=str, default="batch_norm")
    group.add_argument("--model.normalization.groups", type=int, default=1)
    group.add_argument(
        "--model.normalization.momentum", type=float, default=0.1,
        help="BN momentum in the torch convention (fraction of new batch statistic)",
    )
    group.add_argument("--model.normalization.adjust-bn-momentum.enable",
                       action="store_true")
    group.add_argument("--model.normalization.adjust-bn-momentum.anneal-type",
                       type=str, default="cosine")
    group.add_argument("--model.normalization.adjust-bn-momentum.final-momentum-value",
                       type=float, default=1e-6)
    return parser
