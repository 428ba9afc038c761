"""Process groups over a (data, model) grid (counterpart of
cvnets_tpu/parallel/mesh.py).

The JAX package runs one program over a mesh of every device, shaped by
``--dev.mesh-shape`` and ``--dev.mesh-axis-names`` (``create_mesh``,
mesh.py:15-35), and shards the batch over its ``data`` axis. The port runs
one process a card: the world is D·M ranks, and rank r sits at the place of
device r in ``np.arange(world).reshape(shape)``, (r // M, r % M) for the
default names ``data model``. ``form_grid`` makes one data group per model
index (the ranks that share a model index, which hold different rows of the
batch) and one model group per data index (the ranks that hold the same rows,
each with its part of the model), with ``dist.new_group`` on every rank in
the same order. Without a ``model`` axis larger than 1 no group is made: the
data group is the default group, as before.

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
  without one. ``data_size()``, ``data_index()``, ``model_size()``,
  ``model_index()``, ``data_group()`` and ``model_group()`` read the grid.
* The collectives that stand for JAX's global batch (the gradients'
  average, synced BatchNorm, the losses' counts, the contrastive all-gather,
  the metrics) run over the data group: the ranks of a model group hold the
  same rows. ``model_all_gather`` and ``model_all_reduce_`` run over the
  model group (``tensor_parallel``, ``ring_attention``, ``moe``).
* ``device_prefetch`` moves each batch to the rank's device ahead of its use,
  on a copy stream of its own on a card, as JAX's puts each batch on the mesh
  from a thread (mesh.py:63-120).

The backend is ``--ddp.backend``, by default (``xla``, the JAX package's
value) NCCL on a card and gloo on the CPU (gloo also takes CUDA tensors: two
ranks can share one card over it, which NCCL refuses). ``check_options``
refuses what the JAX package cannot run either: more than two mesh axes, or
axis names other than ``data`` and ``model``.
"""

from __future__ import annotations

import datetime
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from cvnets_tpu_torch.utils import logger

DATA_AXIS, MODEL_AXIS = "data", "model"
DEFAULT_TIMEOUT_S = 1800.0


def mesh_axes(opts) -> Tuple[List[int], List[str]]:
    """``--dev.mesh-shape`` and its axis names (default ``data`` then
    ``model``), as ``create_mesh`` reads them; an empty shape when none is
    given."""
    shape = [int(s) for s in (getattr(opts, "dev.mesh_shape", None) or [])]
    names = list(getattr(opts, "dev.mesh_axis_names", None) or [])
    if shape and not names:
        names = [DATA_AXIS, MODEL_AXIS][:len(shape)]
    return shape, names


def check_options(opts) -> None:
    """Refuse a mesh the JAX package cannot run: more than two axes, axis
    names other than ``data``/``model``, or as many names as axes not given."""
    shape, names = mesh_axes(opts)
    if len(shape) > 2:
        raise ValueError(f"--dev.mesh-shape {' '.join(map(str, shape))}: at most two axes "
                         f"({DATA_AXIS}, {MODEL_AXIS})")
    if shape and (len(names) != len(shape) or len(set(names)) != len(names)
                  or not set(names) <= {DATA_AXIS, MODEL_AXIS}):
        raise ValueError(f"--dev.mesh-axis-names {' '.join(names)}: one name a mesh axis, "
                         f"each {DATA_AXIS!r} or {MODEL_AXIS!r}")


def grid_shape(opts, world: int) -> Tuple[int, int, List[int], List[str]]:
    """(D, M) of ``world`` ranks under the options, with the mesh's shape (a
    -1 resolved) and axis names; raises unless the shape holds ``world``."""
    check_options(opts)
    shape, names = mesh_axes(opts)
    if not shape:
        return world, 1, [world], [DATA_AXIS]
    try:
        shape = list(np.arange(world).reshape(shape).shape)
    except ValueError:
        raise ValueError(f"--dev.mesh-shape {' '.join(map(str, shape))} does not hold "
                         f"{world} rank(s)") from None
    sizes = dict(zip(names, shape))
    return sizes.get(DATA_AXIS, 1), sizes.get(MODEL_AXIS, 1), shape, names


@dataclass
class Grid:
    """This rank's place in the (data, model) grid and its two groups (None:
    the default group)."""
    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None
    data_ranks: Tuple[int, ...] = (0,)
    model_ranks: Tuple[int, ...] = (0,)


_GRID: Optional[Grid] = None


def form_grid(opts) -> Grid:
    """The grid of the default group under ``--dev.mesh-shape`` (every rank
    calls it, in the same order); one process without a group has the grid
    of one."""
    global _GRID
    world, me = world_size(), rank()
    d, m, shape, names = grid_shape(opts, world)
    # rank r is device r of np.arange(world).reshape(shape); its axes ordered (data, model)
    ranks = np.arange(world).reshape(shape)
    for axis in (DATA_AXIS, MODEL_AXIS):
        if axis not in names:
            ranks, names = ranks[..., None], names + [axis]
    ranks = np.transpose(ranks, (names.index(DATA_AXIS), names.index(MODEL_AXIS)))
    di, mi = (int(i[0]) for i in np.nonzero(ranks == me))
    grid = Grid(d, m, di, mi, None, None, tuple(int(r) for r in ranks[:, mi]),
                tuple(int(r) for r in ranks[di, :]))
    if m > 1:
        for col in range(m):  # every rank makes every group, in one order
            g = dist.new_group([int(r) for r in ranks[:, col]])
            if col == mi:
                grid.data_group = g
        for row in range(d):
            g = dist.new_group([int(r) for r in ranks[row, :]])
            if row == di:
                grid.model_group = g
    _GRID = grid
    return grid


def grid() -> Grid:
    """The formed grid, else the default group's: every rank on the data axis."""
    if _GRID is not None:
        return _GRID
    return Grid(world_size(), 1, rank(), 0, None, None, tuple(range(world_size())),
                (rank(),))


def data_size() -> int:
    return grid().data


def data_index() -> int:
    return grid().data_index


def model_size() -> int:
    return grid().model


def model_index() -> int:
    return grid().model_index


def data_group():
    return grid().data_group


def model_group():
    return grid().model_group


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
    global _GRID
    _GRID = None
    if is_initialized():
        dist.destroy_process_group()
    logger.set_quiet(False)


def requested_world_size(opts, device: Union[str, torch.device, None]) -> int:
    """Processes to run: ``--dev.num-devices``, else the mesh's size where
    ``--dev.mesh-shape`` gives every axis, else every visible card (1 on the
    CPU)."""
    n = getattr(opts, "dev.num_devices", -1) or -1
    if n > 0:
        return n
    shape, _ = mesh_axes(opts)
    if shape and all(s > 0 for s in shape):
        return int(np.prod(shape))
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
        form_grid(opts)
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
        if _GRID is None:
            form_grid(opts)
        return fn(opts, device=rank_device(device, local_rank()))
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:  # torchrun
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = rank_device(device, local)
        init_group(backend_for(opts, dev), int(os.environ["RANK"]),
                   int(os.environ["WORLD_SIZE"]), "env://", timeout_s)
        try:
            form_grid(opts)
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
    grid_shape(opts, 1)  # one process: a mesh of more raises here
    return fn(opts, device=device)


# ---------------------------------------------------------------- collectives
def _size(group) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def all_reduce_(t: torch.Tensor, group: Any = "data") -> torch.Tensor:
    """``t`` summed over the ranks of the data group (or of ``group``), in place."""
    group = data_group() if group == "data" else group
    if _size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def mean_divisor(count: torch.Tensor, global_batch: bool = True) -> torch.Tensor:
    """The divisor that turns a rank's sum into its share of the global mean
    under the gradients' average over the data group: the count summed over
    the data group and clamped at 1, divided by its size. The local sum over
    it, × D ÷ the global count, averages to JAX's global-batch mean and gives
    its gradient. ``global_batch=False`` (or one data rank): the count clamped."""
    count = count.detach().float()
    if not global_batch or data_size() == 1:
        return count.clamp(min=1.0)
    return all_reduce_(count.clone()).clamp(min=1.0) / data_size()


class _AllGather(torch.autograd.Function):
    """Every data rank's rows in data order; the gradient of a rank's rows is
    the sum over the data ranks of the gradients of their copies of them."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.rows = x.shape[0]
        return torch.cat(all_gather(x))

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = all_reduce_(g.contiguous().clone())
        start = data_index() * ctx.rows
        return g[start:start + ctx.rows]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` (equal shapes) concatenated in data order,
    differentiable; ``x`` itself at one data rank."""
    return _AllGather.apply(x) if data_size() > 1 else x


def all_gather(t: torch.Tensor, group: Any = "data") -> list:
    """Every data rank's ``t`` (or every rank's of ``group``), equal shapes, in
    the group's order."""
    group = data_group() if group == "data" else group
    n = _size(group)
    if n == 1:
        return [t]
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def all_gather_objects(obj: Any) -> list:
    """Every data rank's ``obj`` (picklable), in data order: the ranks of a
    model group hold the same rows, so one of them speaks for all."""
    group = data_group()
    n = _size(group)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def model_all_gather(t: torch.Tensor) -> list:
    """Every model rank's ``t`` (equal shapes), in model order."""
    return all_gather(t, model_group()) if model_size() > 1 else [t]


def model_all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group, in place."""
    return all_reduce_(t, model_group()) if model_size() > 1 else t


BUCKET_ELEMENTS = 1 << 25  # 32M elements: 128 MiB of float32 a collective


def sync_gradients(params: Iterable[torch.Tensor]) -> None:
    """Average the gradients over the data group, in flat buckets of one
    dtype: one all-reduce a bucket after the step's last backward (the
    micro-batches before it accumulate locally, as DDP's ``no_sync``). Every
    data rank then holds the same bits. Parameters without a gradient are
    left out on every rank alike (the same model runs the same code on each)."""
    world, group = data_size(), data_group()
    if world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    buckets: dict = {}
    for g in grads:
        buckets.setdefault((g.dtype, g.device), []).append(g)
    for part_list in buckets.values():
        start = 0
        while start < len(part_list):
            stop, size = start, 0
            while stop < len(part_list) and (stop == start or size + part_list[stop].numel()
                                             <= BUCKET_ELEMENTS):
                size += part_list[stop].numel()
                stop += 1
            part = part_list[start:stop]
            flat = torch.cat([g.reshape(-1) for g in part])
            dist.all_reduce(flat, group=group)
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
