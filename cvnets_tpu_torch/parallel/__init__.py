"""Data and model parallelism over every card, one process a card (counterpart
of cvnets_tpu/parallel, whose GSPMD mesh runs one program over every device):

* ``mesh.py`` forms the process group and its (data, model) grid, averages
  the gradients over the data group, and holds the collectives that keep the
  port's numbers those of the JAX package's global batch (synced BatchNorm in
  ``layers/normalization.py``, the losses' global counts, the contrastive
  loss's all-gather, the metrics' gathering);
* ``sharding_rules.py`` is JAX's layout rule for each parameter (which dim
  the ``model`` axis and, under ``--dev.fsdp``, the ``data`` axis shard),
  in the port's tensor layout;
* ``tensor_parallel.py`` runs the port's linear and conv layers column- or
  row-parallel over the model group where the rules shard their weights;
* ``fsdp.py`` keeps each rank's shard of the parameters, the optimizer's
  moments and the EMA, gathers the weights for use and reduce-scatters the
  gradients;
* ``ring_attention.py`` is sequence-parallel attention over the model group
  on the MHA kernels (``--dev.sequence-parallel``).
"""

from cvnets_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    all_gather,
    all_gather_objects,
    all_gather_with_grad,
    all_reduce_,
    barrier,
    broadcast_module_,
    check_options,
    data_group,
    data_index,
    data_size,
    device_prefetch,
    form_grid,
    grid,
    is_initialized,
    is_master,
    launch,
    local_rank,
    mean_divisor,
    model_all_gather,
    model_all_reduce_,
    model_group,
    model_index,
    model_size,
    rank,
    spawn,
    sync_gradients,
    world_size,
)
