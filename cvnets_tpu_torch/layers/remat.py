"""Gradient checkpointing of one module call (the JAX package's ``nn.remat``
of a stage or a block: ``base_image_encoder.py:123-127``, ``vit.py:132-136``,
``swin_transformer.py:116``, ``text_encoders/transformer.py:145-147``).

``remat(module, *args)`` runs ``module(*args)`` under
``torch.utils.checkpoint`` (``use_reentrant=False``): its activations are
dropped after the forward and recomputed in the backward. ``nn.remat`` is
functional, torch's recomputation is not: a BatchNorm in train mode would
update its running statistics a second time. So the recomputation runs with
every BatchNorm of the module at momentum 0 (which leaves the running
statistics as they are) and puts back each one's ``num_batches_tracked``.
Dropout and stochastic depth draw the same numbers in the recomputation
(the checkpoint restores the RNG states). A module's side outputs (MoE's
``aux_loss``) are written again with the same value, never appended. With
the flag on, the loss, the gradients and the running statistics equal those
of a run without it.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch.nn as nn
from torch.utils.checkpoint import checkpoint


@contextmanager
def frozen_batch_norm_stats(module: nn.Module):
    """Every BatchNorm under ``module`` at momentum 0, its step counter kept."""
    norms = [m for m in module.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
             and m.track_running_stats]
    saved = [(m.momentum, m.num_batches_tracked.clone()) for m in norms]
    for m in norms:
        m.momentum = 0.0
    try:
        yield
    finally:
        for m, (momentum, count) in zip(norms, saved):
            m.momentum = momentum
            m.num_batches_tracked.copy_(count)


def remat(module: nn.Module, *args):
    """``module(*args)``, its activations recomputed in the backward."""
    calls = [0]

    def run(*inputs):
        calls[0] += 1
        if calls[0] == 1:
            return module(*inputs)
        with frozen_batch_norm_stats(module):  # the backward's recomputation
            return module(*inputs)

    return checkpoint(run, *args, use_reentrant=False)
