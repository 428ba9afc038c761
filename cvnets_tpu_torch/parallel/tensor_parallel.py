"""Tensor parallelism over the model group (the ``model`` axis of
cvnets_tpu/parallel/sharding_rules.py:8-16, "without touching any model
code").

JAX shards the weights and lets GSPMD partition the products. The port takes
the same layout after the model is built and swaps the class of each linear
and conv layer whose weight the rules shard over ``model`` for a
tensor-parallel one that holds the rank's shard under the same names:

* column-parallel (the output features or channels sharded): the layer
  computes its shard of the output and gathers it over the model group,
  differentiably (the gradient of the gathered output is sliced back). The
  input enters through ``copy_to_model``, whose backward sums the input's
  gradient over the group (each rank's is only its shard's part). A grouped
  or depthwise conv splits its groups with its channels: it takes its shard
  of the input channels (``scatter_to_model``). A bias that the rules shard
  is added before the gather, a whole one after it.
* row-parallel (the input features or channels sharded, under a row token):
  the layer takes its slice of the input (``scatter_to_model``, whose
  backward gathers the slices' gradients), and sums the partial products
  over the group in float32 (``reduce_from_model``, identity backward); the
  whole bias is added after.

Every rank of a model group thus holds the whole activation between layers
and computes the same thing outside these layers, so the gradients of the
parameters it holds whole are the same on every rank of the group. The
gather after each column-parallel layer keeps the math exact and simple
(Megatron's pairing without it is a later speed lever, ROADMAP.md queue 2).

A layer the swap cannot split (a grouped conv whose groups the axis does
not divide, a row-parallel grouped conv, a padding mode other than zeros,
an int8 layer) keeps its class; ``fsdp.ShardedState`` then stores its
sharded leaves as shards and gathers them whole for use, as it does every
other leaf the rules shard over ``model`` (LayerNorm and BatchNorm scales,
an MoE router's bias).
"""

from __future__ import annotations

from typing import Dict, Set

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.parallel import mesh
from cvnets_tpu_torch.parallel.sharding_rules import LeafSpec


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return mesh.model_all_reduce_(g.contiguous().clone())


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return mesh.model_all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim, ctx.size = dim, x.shape[dim]
        return torch.cat(mesh.model_all_gather(x.contiguous()), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, mesh.model_index() * ctx.size, ctx.size), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int):
        size = x.shape[dim] // mesh.model_size()
        ctx.dim = dim
        return x.narrow(dim, mesh.model_index() * size, size)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(mesh.model_all_gather(g.contiguous()), dim=ctx.dim), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x``; its gradient summed over the model group."""
    return _CopyToModel.apply(x) if mesh.model_size() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group; its gradient as it is."""
    return _ReduceFromModel.apply(x) if mesh.model_size() > 1 else x


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim``; the gradient sliced."""
    return _GatherFromModel.apply(x, dim % x.dim()) if mesh.model_size() > 1 else x


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's slice of ``x`` along ``dim``; the gradient gathered."""
    return _ScatterToModel.apply(x, dim % x.dim()) if mesh.model_size() > 1 else x


def _reduce_partial(part: torch.Tensor) -> torch.Tensor:
    """The row-parallel partial products summed over the model group, a
    half-precision product in float32."""
    if part.dtype in (torch.bfloat16, torch.float16):
        return reduce_from_model(part.float()).to(part.dtype)
    return reduce_from_model(part)


def _add_bias(y: torch.Tensor, bias, dim: int) -> torch.Tensor:
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + bias.to(y.dtype).view(shape)


class _TensorParallel:
    """Set by ``apply_tensor_parallel``: ``tp_bias_local`` (the bias is the
    rank's shard) and, on a column-parallel conv, ``tp_groups`` (its groups
    on this rank)."""

    tp_bias_local = False


class ColumnParallelLinear(_TensorParallel):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        local = self.bias if self.tp_bias_local else None
        y = gather_from_model(F.linear(copy_to_model(x), self.weight, local), -1)
        return y if self.tp_bias_local else _add_bias(y, self.bias, -1)


class RowParallelLinear(_TensorParallel):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _reduce_partial(F.linear(scatter_to_model(x, -1), self.weight))
        return _add_bias(y, self.bias, -1)


class ColumnParallelConv2d(_TensorParallel):
    tp_groups = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x) if self.groups == 1 else scatter_to_model(x, 1)
        local = self.bias if self.tp_bias_local else None
        y = F.conv2d(x, self.weight, local, self.stride, self.padding, self.dilation,
                     self.tp_groups)
        y = gather_from_model(y, 1)
        return y if self.tp_bias_local else _add_bias(y, self.bias, 1)


class RowParallelConv2d(_TensorParallel):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _reduce_partial(F.conv2d(scatter_to_model(x, 1), self.weight, None, self.stride,
                                     self.padding, self.dilation, 1))
        return _add_bias(y, self.bias, 1)


_CLASSES: Dict[tuple, type] = {}


def _swap_class(module: nn.Module, mixin: type) -> None:
    key = (type(module), mixin)
    if key not in _CLASSES:
        _CLASSES[key] = type(f"{mixin.__name__}[{type(module).__name__}]",
                             (mixin, type(module)), {})
    module.__class__ = _CLASSES[key]


def _mode(module: nn.Module, spec: LeafSpec, m: int):
    """The tensor-parallel class for ``module`` under its weight's spec, or None."""
    if spec.model_dim is None:
        return None
    if isinstance(module, nn.Linear) and type(module).forward is nn.Linear.forward:
        return ColumnParallelLinear if spec.model_dim == 0 else RowParallelLinear
    if (isinstance(module, nn.Conv2d) and type(module).forward is nn.Conv2d.forward
            and module.padding_mode == "zeros" and isinstance(module.padding, tuple)):
        if spec.model_dim == 0 and (module.groups == 1 or module.groups % m == 0):
            return ColumnParallelConv2d
        if spec.model_dim == 1 and module.groups == 1:
            return RowParallelConv2d
    return None


def _shard(t: torch.Tensor, dim: int) -> torch.Tensor:
    size = t.shape[dim] // mesh.model_size()
    return t.narrow(dim, mesh.model_index() * size, size).clone()


@torch.no_grad()
def apply_tensor_parallel(model: nn.Module, specs: Dict[str, LeafSpec]) -> Set[str]:
    """Swap the layers the rules split for their tensor-parallel classes, their
    weights (and sharded biases) cut to this model rank's shard in place (the
    same Parameter objects). Returns the names of the parameters a layer now
    holds as its shard; every other parameter stays whole. A no-op at one
    model rank. MoE layers take their share of the experts
    (``modules/moe.MoEFFN.expert_offset``)."""
    from cvnets_tpu_torch.modules.moe import MoEFFN

    m = mesh.model_size()
    local: Set[str] = set()
    if m == 1:
        return local
    for prefix, module in model.named_modules():
        prefix = f"{prefix}." if prefix else ""
        if isinstance(module, MoEFFN):
            names = [n for n, _ in module.named_parameters(recurse=False)]
            if all(specs[prefix + n].model_dim == 0 for n in names):
                for n in names:
                    p = getattr(module, n)
                    p.data = _shard(p.data, 0)
                    local.add(prefix + n)
                module.expert_offset = mesh.model_index() * (module.num_experts // m)
            continue
        weight = getattr(module, "weight", None)
        if not isinstance(weight, nn.Parameter) or prefix + "weight" not in specs:
            continue
        spec = specs[prefix + "weight"]
        mixin = _mode(module, spec, m)
        if mixin is None:
            continue
        weight.data = _shard(weight.data, spec.model_dim)
        local.add(prefix + "weight")
        bias = module.bias
        bias_spec = specs.get(prefix + "bias", LeafSpec())
        if (bias is not None and mixin in (ColumnParallelLinear, ColumnParallelConv2d)
                and bias_spec.model_dim == 0):
            bias.data = _shard(bias.data, 0)
            local.add(prefix + "bias")
            module.tp_bias_local = True
        if mixin is ColumnParallelConv2d and module.groups > 1:
            module.tp_groups = module.groups // m
        _swap_class(module, mixin)
    return local
