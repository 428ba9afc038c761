"""Process groups for data-parallel training (counterpart of
cvnets_tpu/parallel/mesh.py).

The JAX package runs one program over a mesh of every device and shards the
batch over its ``data`` axis. The port runs one process a card, each with its
shard of the batch: the group is ``torch.distributed``'s default group, one
rank a process.

* ``launch(fn, opts, device)`` runs an entry point's ``fn(opts, device=...)``:
  inside a group that already exists; under ``torchrun`` (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK`` in the environment), in the group it
  describes; when more than one process is asked for
  (``requested_world_size``), in that many spawned processes, one a card; else
  in this process without a group. A rank that raises ends every rank (the
  spawn's join terminates the others) and the exception reaches the caller,
  so the program exits nonzero. A group that fails to form raises too.
* ``torch.cuda.set_device(local_rank)`` runs before anything touches CUDA, so
  each rank's ``cuda`` is its own card (the kernels' launcher enters the
  tensor's device anyway, ``ops/cuda_build.py``).
* ``world_size()``, ``rank()``, ``local_rank()``, ``is_master()`` and
  ``barrier()`` read the default group, and are 1, 0, 0, True and a no-op
  without one.
* ``device_prefetch`` moves each batch to the rank's device ahead of its use,
  on a copy stream of its own on a card, as JAX's puts each batch on the mesh
  from a thread (mesh.py:63-120).

The backend is ``--ddp.backend``, by default (``xla``, the JAX package's
value) NCCL on a card and gloo on the CPU (gloo also takes CUDA tensors: two
ranks can share one card over it, which NCCL refuses). Model parallelism (``--dev.fsdp``,
``--dev.sequence-parallel``, a ``model`` mesh axis) is not ported:
``check_options`` refuses it and names its ROADMAP item.
"""

from __future__ import annotations

import datetime
import os
import time
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Union

import torch
import torch.distributed as dist

from cvnets_tpu_torch.utils import logger

MODEL_PARALLEL_ITEM = "model parallelism (ROADMAP.md queue 1 item 14)"
DEFAULT_TIMEOUT_S = 1800.0


def check_options(opts) -> None:
    """Refuse the model-parallel flags: the port trains data-parallel only."""
    if getattr(opts, "dev.fsdp", False):
        raise NotImplementedError(f"--dev.fsdp is not ported: it waits for {MODEL_PARALLEL_ITEM}")
    if getattr(opts, "dev.sequence_parallel", False):
        raise NotImplementedError(
            f"--dev.sequence-parallel is not ported: it waits for {MODEL_PARALLEL_ITEM}")
    shape = getattr(opts, "dev.mesh_shape", None) or []
    names = getattr(opts, "dev.mesh_axis_names", None) or ["data", "model"][:len(shape)]
    for size, name in zip(shape[1:], names[1:]):
        if int(size) > 1:
            raise NotImplementedError(
                f"--dev.mesh-shape {' '.join(map(str, shape))}: a '{name}' axis of {size} is "
                f"model parallelism, which waits for {MODEL_PARALLEL_ITEM}")


# ------------------------------------------------------------------ the group
def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank())) if is_initialized() else 0


def is_master() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def backend_for(opts, device: torch.device) -> str:
    """``--ddp.backend``; its default, the JAX package's ``xla``, is the
    device's own: NCCL on a card, gloo on the CPU."""
    backend = getattr(opts, "ddp.backend", None)
    if backend and backend != "xla":
        return backend
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: Union[str, torch.device, None], local: int) -> torch.device:
    """The device of local rank ``local``: its card, or the CPU."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    torch.cuda.set_device(local)  # before any other CUDA call of this process
    return torch.device("cuda", local)


def init_group(backend: str, rank_: int, world: int, init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default group; raises if it does not form within ``timeout_s``."""
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            rank=rank_, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if rank_ != 0:
        logger.set_quiet(True)  # logs, summaries and checkpoints are the master's


def destroy_group() -> None:
    if is_initialized():
        dist.destroy_process_group()
    logger.set_quiet(False)


def requested_world_size(opts, device: Union[str, torch.device, None]) -> int:
    """Processes to run: ``--dev.num-devices`` (-1: every visible card; 1 on
    the CPU)."""
    n = getattr(opts, "dev.num_devices", -1) or -1
    if n > 0:
        return n
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def init_method_for(opts) -> str:
    url = getattr(opts, "ddp.dist_url", None)
    if url:
        return url
    return f"tcp://localhost:{getattr(opts, 'ddp.dist_port', 30786) or 30786}"


def _spawned(index: int, fn: Callable, opts, device, world: int, init_method: str,
             timeout_s: float) -> None:
    os.environ["LOCAL_RANK"] = str(index)
    dev = rank_device(device, index)
    init_group(backend_for(opts, dev), index, world, init_method, timeout_s)
    try:
        fn(opts, device=dev)
    finally:
        destroy_group()


class Spawned:
    """Processes started by ``spawn``; ``join`` waits for them."""

    def __init__(self, context, timeout_s: Optional[float]) -> None:
        self.context = context
        self.deadline = None if timeout_s is None else time.monotonic() + timeout_s
        self.timeout_s = timeout_s

    def join(self) -> None:
        """Raises the first failure (the others are terminated), or
        ``TimeoutError`` past the deadline, when every process is killed."""
        while not self.context.join(timeout=1.0):
            if self.deadline is not None and time.monotonic() > self.deadline:
                for p in self.context.processes:
                    if p.is_alive():
                        p.kill()
                for p in self.context.processes:
                    p.join()
                raise TimeoutError(f"{len(self.context.processes)} spawned processes did "
                                   f"not end in {self.timeout_s} s")


def spawn(fn: Callable, nprocs: int, args: tuple = (), timeout_s: Optional[float] = None,
          join: bool = True) -> Optional[Spawned]:
    """``fn(index, *args)`` in ``nprocs`` spawned processes, joined (see
    ``Spawned.join``) unless ``join`` is false, when they are returned."""
    import torch.multiprocessing as mp

    spawned = Spawned(mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                                         start_method="spawn"), timeout_s)
    if not join:
        return spawned
    spawned.join()
    return None


def launch(fn: Callable, opts, device: Union[str, torch.device, None] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """Run ``fn(opts, device=...)`` as set out in the module's docstring; its
    result where it ran in this process, else None."""
    check_options(opts)
    if is_initialized():
        return fn(opts, device=rank_device(device, local_rank()))
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:  # torchrun
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = rank_device(device, local)
        init_group(backend_for(opts, dev), int(os.environ["RANK"]),
                   int(os.environ["WORLD_SIZE"]), "env://", timeout_s)
        try:
            return fn(opts, device=dev)
        finally:
            destroy_group()
    world = requested_world_size(opts, device)
    if world > 1:
        dev = torch.device(device if device is not None else "cuda")
        if dev.type == "cuda" and world > torch.cuda.device_count():
            raise ValueError(f"{world} processes asked for, {torch.cuda.device_count()} "
                             "cards visible")
        spawn(_spawned, world, (fn, opts, device, world, init_method_for(opts), timeout_s))
        return None
    return fn(opts, device=device)


# ---------------------------------------------------------------- collectives
def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def mean_divisor(count: torch.Tensor, global_batch: bool = True) -> torch.Tensor:
    """The divisor that turns a rank's sum into its share of the global mean
    under the gradients' average over ranks: the count summed over the ranks
    and clamped at 1, divided by the world size. The local sum over it, ×
    world ÷ the global count, averages to JAX's global-batch mean and gives
    its gradient. ``global_batch=False`` (or one process): the count clamped."""
    count = count.detach().float()
    if not global_batch or world_size() == 1:
        return count.clamp(min=1.0)
    return all_reduce_(count.clone()).clamp(min=1.0) / world_size()


class _AllGather(torch.autograd.Function):
    """Every rank's rows in rank order; the gradient of a rank's rows is the
    sum over the ranks of the gradients of their copies of them."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.rows = x.shape[0]
        return torch.cat(all_gather(x))

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = all_reduce_(g.contiguous().clone())
        start = rank() * ctx.rows
        return g[start:start + ctx.rows]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated in rank order,
    differentiable; ``x`` itself in one process."""
    return _AllGather.apply(x) if world_size() > 1 else x


def all_gather(t: torch.Tensor) -> list:
    """Every rank's ``t`` (equal shapes), in rank order."""
    if world_size() == 1:
        return [t]
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t.contiguous())
    return parts


def all_gather_objects(obj: Any) -> list:
    """Every rank's ``obj`` (picklable), in rank order."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


BUCKET_ELEMENTS = 1 << 25  # 32M elements: 128 MiB of float32 a collective


def sync_gradients(params: Iterable[torch.Tensor]) -> None:
    """Average the gradients over the ranks, in flat buckets of one dtype: one
    all-reduce a bucket after the step's last backward (the micro-batches
    before it accumulate locally, as DDP's ``no_sync``). Every rank then holds
    the same bits. Parameters without a gradient are left out on every rank
    alike (the same model runs the same code on each)."""
    world = world_size()
    if world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    buckets: dict = {}
    for g in grads:
        buckets.setdefault((g.dtype, g.device), []).append(g)
    for group in buckets.values():
        start = 0
        while start < len(group):
            stop, size = start, 0
            while stop < len(group) and (stop == start or size + group[stop].numel()
                                         <= BUCKET_ELEMENTS):
                size += group[stop].numel()
                stop += 1
            part = group[start:stop]
            flat = torch.cat([g.reshape(-1) for g in part])
            dist.all_reduce(flat)
            flat.div_(world)
            torch._foreach_copy_(part, [v.view_as(g) for v, g in
                                        zip(flat.split([g.numel() for g in part]), part)])
            start = stop


def broadcast_module_(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` set to rank 0's."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


# ---------------------------------------------------------------- prefetching
def device_prefetch(iterable: Iterable, device: torch.device, depth: int = 2
                    ) -> Iterator:
    """Each batch (a dict tree of tensors) of ``iterable`` on ``device``. On a
    card the copies are issued ``depth`` batches ahead on a stream of their
    own, and each batch is ordered before the consumer's later work on its
    stream (and its tensors marked as used there); elsewhere the batch is
    moved when it is taken."""
    from cvnets_tpu_torch.engine.train_state import tree_map  # it imports this module

    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterable:
            yield tree_map(lambda t: t.to(device), batch)
        return
    stream = torch.cuda.Stream(device)
    pending: deque = deque()

    def ready(batch, event):
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        tree_map(lambda t: t.record_stream(current) if t.is_cuda else None, batch)
        return batch

    for batch in iterable:
        with torch.cuda.stream(stream):
            batch = tree_map(lambda t: t.to(device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(stream)
        pending.append((batch, event))
        if len(pending) > depth:
            yield ready(*pending.popleft())
    while pending:
        yield ready(*pending.popleft())
