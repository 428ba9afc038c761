"""Data parallelism over every card, one process a card (counterpart of
cvnets_tpu/parallel, whose GSPMD mesh runs one program over every device):
``mesh.py`` forms the process group, averages the gradients, and holds the
collectives that keep the port's numbers those of the JAX package's global
batch (synced BatchNorm in ``layers/normalization.py``, the losses' global
counts, the contrastive loss's all-gather, the metrics' gathering)."""

from cvnets_tpu_torch.parallel.mesh import (  # noqa: F401
    MODEL_PARALLEL_ITEM,
    all_gather,
    all_gather_objects,
    all_gather_with_grad,
    all_reduce_,
    barrier,
    broadcast_module_,
    check_options,
    device_prefetch,
    is_initialized,
    is_master,
    launch,
    local_rank,
    mean_divisor,
    rank,
    spawn,
    sync_gradients,
    world_size,
)
