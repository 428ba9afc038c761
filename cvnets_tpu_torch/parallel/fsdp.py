"""Sharded train state over the (data, model) grid: FSDP (``--dev.fsdp``) and
the storage of tensor parallelism (counterpart of the JAX Trainer's
``_place_state``, cvnets_tpu/engine/training_engine.py:121-123, 250-262, and
of ``state_shardings``, cvnets_tpu/parallel/sharding_rules.py:125-170).

JAX places every parameter, its AdamW moments and its EMA copy by the
layout rules (``sharding_rules``) and lets XLA gather and reduce-scatter.
``ShardedState`` does it by hand on the port's Trainer:

* each parameter has its spec; this rank stores its block (its model slice
  along the spec's model dim, its data slice along the data dim) as the
  optimizer's parameter, and the optimizer's moments and the EMA follow the
  storage. A parameter that no axis shards, or that a tensor-parallel layer
  holds as its model shard without a data dim, is its own storage (the
  BatchNorm statistics and the small leaves stay replicated, as in JAX).
* ``gather()`` writes the weights for use into the model's parameters: each
  stored block gathered over the data group along its data dim and, where no
  tensor-parallel layer takes the shard, over the model group too. It is
  one whole-model gather at the start of a step (not one a block), and the
  gathered weights are freed after the optimizer's step.
* ``reduce_grads()`` turns the model's gradients into the storage's: the
  gradient of a whole-used model-sharded leaf is the same on every model
  rank, and the rank keeps its slice; over the data group each gradient is
  reduce-scattered to its block (all-reduced where no data dim shards it)
  and averaged.
* ``clip_()`` takes the global gradient norm that JAX's ``grad_clip`` sees:
  the squares of each block summed over the groups that shard it, each
  replicated leaf once.
* the EMA keeps a block a leaf beside the storage, and a copy of the model
  whose weights are gathered from it for an EMA evaluation.
* ``full_state_dict`` / ``full_optimizer_state_dict`` gather whole tensors
  for a checkpoint (a collective: every rank calls it; the master writes),
  so a checkpoint loads into one process; ``load_full_*`` cut them back.

Collectives: list ``all_gather`` and ``reduce_scatter_tensor``, which NCCL
and gloo both take on CUDA tensors (two gloo ranks sharing an H100 run
both; gloo aborts only on ``isend``/``irecv`` of one, which the ring avoids).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from cvnets_tpu_torch.parallel import mesh
from cvnets_tpu_torch.parallel.sharding_rules import LeafSpec, infer_param_specs
from cvnets_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel


def _slice(t: torch.Tensor, dim: Optional[int], index: int, parts: int) -> torch.Tensor:
    if dim is None or parts == 1:
        return t
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size)


def block(full: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
    """This rank's block of a whole tensor under ``spec``."""
    t = _slice(full, spec.model_dim, mesh.model_index(), mesh.model_size())
    return _slice(t, spec.data_dim, mesh.data_index(), mesh.data_size())


def _gather(t: torch.Tensor, dim: Optional[int], group, parts: int) -> torch.Tensor:
    if dim is None or parts == 1:
        return t
    return torch.cat(mesh.all_gather(t.contiguous(), group), dim=dim)


def _reduce_scatter_mean(g: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``g`` averaged over the data group, cut to this rank's block along ``dim``."""
    n, group = mesh.data_size(), mesh.data_group()
    if n == 1:
        return g
    if dim is None:
        return mesh.all_reduce_(g.contiguous()).div_(n)
    x = g.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.div_(n).movedim(0, dim)


@dataclass
class Leaf:
    name: str
    param: nn.Parameter                  # the model's weight for use
    spec: LeafSpec
    local: bool                          # a tensor-parallel layer takes its model shard
    storage: nn.Parameter                # this rank's block (``param`` where aliased)
    ema_param: Optional[nn.Parameter] = None
    ema_storage: Optional[torch.Tensor] = None

    @property
    def aliased(self) -> bool:
        return self.storage is self.param

    def whole_use(self, t: torch.Tensor) -> torch.Tensor:
        """A stored block gathered into the tensor the model uses."""
        t = _gather(t, self.spec.data_dim, mesh.data_group(), mesh.data_size())
        if not self.local:
            t = _gather(t, self.spec.model_dim, mesh.model_group(), mesh.model_size())
        return t

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """A stored block gathered into the whole tensor."""
        t = _gather(t, self.spec.data_dim, mesh.data_group(), mesh.data_size())
        return _gather(t, self.spec.model_dim, mesh.model_group(), mesh.model_size())


class ShardedEMA:
    """The EMA of a sharded state: ``model`` is its copy of the model, whose
    sharded weights ``ShardedState.gather(use_ema=True)`` gathers."""

    def __init__(self, state: "ShardedState", model: nn.Module) -> None:
        self.state, self.model = state, model

    def update(self, model: nn.Module, momentum: float) -> None:
        del model
        self.state.update_ema(momentum)


class ShardedState:
    def __init__(self, model: nn.Module, optimizer: Optional[torch.optim.Optimizer],
                 ema_model: Optional[nn.Module], specs: Dict[str, LeafSpec]) -> None:
        if optimizer is not None and optimizer.state:
            raise ValueError("shard the state before the optimizer's first step")
        self.model, self.specs = model, specs
        blocks = {n: block(p.data, specs[n]).clone() for n, p in model.named_parameters()
                  if specs[n].sharded}
        ema_blocks = {} if ema_model is None else {
            n: block(p.data, specs[n]).clone() for n, p in ema_model.named_parameters()
            if specs[n].sharded}
        local = apply_tensor_parallel(model, specs)
        if ema_model is not None:
            apply_tensor_parallel(ema_model, specs)
        ema_params = dict(ema_model.named_parameters()) if ema_model is not None else {}
        self.leaves: List[Leaf] = []
        for name, p in model.named_parameters():
            spec = specs[name]
            keeps = spec.data_dim is None and (spec.model_dim is None or name in local)
            storage = p if keeps else nn.Parameter(blocks[name], requires_grad=p.requires_grad)
            leaf = Leaf(name, p, spec, name in local, storage)
            if ema_model is not None:
                leaf.ema_param = ema_params[name]
                leaf.ema_storage = leaf.ema_param.data if keeps else ema_blocks[name]
            self.leaves.append(leaf)
        if optimizer is not None:
            swap = {id(leaf.param): leaf.storage for leaf in self.leaves if not leaf.aliased}
            for group in optimizer.param_groups:
                group["params"] = [swap.get(id(p), p) for p in group["params"]]
        self.ema = ShardedEMA(self, ema_model) if ema_model is not None else None
        self._fresh = {False: False, True: False}
        self.free()

    # ------------------------------------------------------------ weights
    def _sharded(self) -> List[Leaf]:
        return [leaf for leaf in self.leaves if not leaf.aliased]

    @torch.no_grad()
    def gather(self, use_ema: bool = False) -> nn.Module:
        """The model (or the EMA's copy) with its weights gathered for use;
        every rank calls it, and it gathers once after each update."""
        if not self._fresh[use_ema]:
            for leaf in self._sharded():
                target = leaf.ema_param if use_ema else leaf.param
                target.data = leaf.whole_use(leaf.ema_storage if use_ema else leaf.storage.data)
            self._fresh[use_ema] = True
        return self.ema.model if use_ema else self.model

    def free(self, use_ema: Optional[bool] = None) -> None:
        """Drop the gathered weights (both copies' by default)."""
        for ema in ((False, True) if use_ema is None else (use_ema,)):
            for leaf in self._sharded():
                target = leaf.ema_param if ema else leaf.param
                if target is not None:
                    target.data = target.data.new_empty(0)
                    target.grad = None
            self._fresh[ema] = False

    # ---------------------------------------------------------- gradients
    @torch.no_grad()
    def reduce_grads(self) -> None:
        """The model's gradients (the step's, after its last backward) into the
        storage's: averaged over the data group, each cut to its block."""
        mesh.sync_gradients([leaf.param for leaf in self.leaves if leaf.aliased])
        for leaf in self._sharded():
            g = leaf.param.grad
            if g is None:
                leaf.storage.grad = None
                continue
            if leaf.spec.model_dim is not None and not leaf.local:
                g = _slice(g, leaf.spec.model_dim, mesh.model_index(), mesh.model_size())
            leaf.storage.grad = _reduce_scatter_mean(g, leaf.spec.data_dim).contiguous()
            leaf.param.grad = None

    @torch.no_grad()
    def clip_(self, grad_clip: Optional[float]) -> torch.Tensor:
        """Scale the storage's gradients by ``min(1, clip / (norm + 1e-6))``
        and return the pre-clip global norm: the squares of each block summed
        over the groups that shard it, a replicated leaf counted once."""
        grads = {key: [] for key in ((False, False), (True, False), (False, True),
                                     (True, True))}
        for leaf in self.leaves:
            if leaf.storage.grad is not None:
                key = (leaf.spec.data_dim is not None and mesh.data_size() > 1,
                       leaf.spec.model_dim is not None and mesh.model_size() > 1)
                grads[key].append(leaf.storage.grad)
        all_grads = [g for part in grads.values() for g in part]
        ref = all_grads[0]
        sums = torch.stack([
            torch.stack(torch._foreach_norm(part)).float().pow(2).sum() if part
            else torch.zeros((), device=ref.device) for part in grads.values()])
        mesh.all_reduce_(sums[1:2])
        mesh.model_all_reduce_(sums[2:3])
        if mesh.world_size() > 1:
            mesh.all_reduce_(sums[3:4], None)
        norm = sums.sum().sqrt()
        if grad_clip is not None and grad_clip > 0:
            torch._foreach_mul_(all_grads, torch.clamp(grad_clip / (norm + 1e-6), max=1.0))
        return norm

    def after_step(self) -> None:
        """The storage moved: the gathered weights are stale, and freed."""
        self.free(False)

    @torch.no_grad()
    def update_ema(self, momentum: float) -> None:
        targets = [leaf.ema_storage for leaf in self.leaves]
        sources = [leaf.storage.data for leaf in self.leaves]
        for ema_buf, buf in zip(self.ema.model.buffers(), self.model.buffers()):
            if buf.is_floating_point():
                targets.append(ema_buf)
                sources.append(buf)
        torch._foreach_lerp_(targets, sources, momentum)
        self.free(True)

    # --------------------------------------------------------- accounting
    def state_bytes(self, optimizer: Optional[torch.optim.Optimizer] = None) -> int:
        """This rank's parameters, optimizer moments and EMA, in bytes (the
        gathered weights for use, freed between steps, not counted)."""
        tensors = {id(leaf.storage): leaf.storage for leaf in self.leaves}
        if self.ema is not None:
            tensors.update({id(leaf.ema_storage): leaf.ema_storage for leaf in self.leaves})
        if optimizer is not None:
            for st in optimizer.state.values():
                tensors.update({id(v): v for k, v in st.items()
                                if isinstance(v, torch.Tensor) and k != "step"})
        return sum(t.numel() * t.element_size() for t in tensors.values())

    # -------------------------------------------------------- checkpoints
    @torch.no_grad()
    def full_state_dict(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """The model's (or the EMA's) state dict with whole tensors; every rank
        calls it."""
        module = self.ema.model if use_ema else self.model
        sd = dict(module.state_dict())
        for leaf in self.leaves:
            src = leaf.ema_storage if use_ema else leaf.storage.data
            sd[leaf.name] = leaf.whole(src)
        return sd

    @torch.no_grad()
    def load_full_state_dict(self, sd: Dict[str, torch.Tensor], use_ema: bool = False) -> None:
        module = self.ema.model if use_ema else self.model
        missing = sorted(set(self.specs) - set(sd))
        if missing:
            raise KeyError(f"the checkpoint lacks {missing[:8]}")
        for leaf in self.leaves:
            dst = leaf.ema_storage if use_ema else leaf.storage.data
            dst.copy_(block(sd[leaf.name], leaf.spec))
        for name, buf in module.named_buffers():
            buf.copy_(sd[name])
        self.free(use_ema)

    def _optimizer_leaves(self, optimizer) -> Dict[int, Leaf]:
        by_storage = {id(leaf.storage): leaf for leaf in self.leaves}
        params = [p for group in optimizer.param_groups for p in group["params"]]
        return {i: by_storage[id(p)] for i, p in enumerate(params) if id(p) in by_storage}

    @torch.no_grad()
    def full_optimizer_state_dict(self, optimizer) -> dict:
        """The optimizer's state dict with whole moments; every rank calls it."""
        sd = optimizer.state_dict()
        leaves = self._optimizer_leaves(optimizer)
        state = {}
        for idx in sorted(sd["state"]):
            st, leaf = dict(sd["state"][idx]), leaves.get(idx)
            if leaf is not None and leaf.spec.sharded:
                st = {k: (leaf.whole(v) if isinstance(v, torch.Tensor)
                          and v.shape == leaf.storage.shape and v.dim() > 0 else v)
                      for k, v in st.items()}
            state[idx] = st
        return {**sd, "state": state}

    def load_full_optimizer_state_dict(self, optimizer, sd: dict) -> None:
        leaves = self._optimizer_leaves(optimizer)
        state = {}
        for idx, st in sd["state"].items():
            leaf = leaves.get(int(idx))
            if leaf is not None and leaf.spec.sharded:
                full_shape = self._whole_shape(leaf)
                st = {k: (block(v, leaf.spec).clone() if isinstance(v, torch.Tensor)
                          and tuple(v.shape) == full_shape else v) for k, v in st.items()}
            state[idx] = st
        optimizer.load_state_dict({**sd, "state": state})

    def _whole_shape(self, leaf: Leaf) -> tuple:
        """The whole shape of a leaf."""
        shape = list(leaf.storage.shape)
        if leaf.spec.model_dim is not None:
            shape[leaf.spec.model_dim] *= mesh.model_size()
        if leaf.spec.data_dim is not None:
            shape[leaf.spec.data_dim] *= mesh.data_size()
        return tuple(shape)


def wants_sharding(opts) -> bool:
    """JAX's ``_place_state`` rule: shard under ``--dev.fsdp`` or a model axis
    larger than 1, else replicate."""
    return bool(getattr(opts, "dev.fsdp", False)) or mesh.model_size() > 1


def shard_train_state(opts, state):
    """``state`` (a ``TrainState`` whose model, optimizer and EMA are whole and
    the same on every rank) sharded by the rules over the current grid:
    ``state.shards`` is its ``ShardedState`` and ``state.ema`` its EMA."""
    specs = infer_param_specs(state.model, mesh.data_size(), mesh.model_size(),
                              fsdp=bool(getattr(opts, "dev.fsdp", False)))
    shards = ShardedState(state.model, state.optimizer,
                          state.ema.model if state.ema is not None else None, specs)
    state.shards, state.ema = shards, shards.ema
    return state


def shard_eval_model(opts, model: nn.Module) -> nn.Module:
    """A whole model laid out over the grid for evaluation (``main_eval``):
    its weights gathered for use, tensor-parallel where the rules split it."""
    specs = infer_param_specs(model, mesh.data_size(), mesh.model_size(),
                              fsdp=bool(getattr(opts, "dev.fsdp", False)))
    return ShardedState(model, None, None, specs).gather()
