"""Evaluator (counterpart of cvnets_tpu/engine/evaluation_engine.py:18-70): the
``stats.val`` metrics of a model over a loader, the model given or filled from
a ``checkpoint_*.pt`` (a model state dict). A shift set's
``stats.logit_subset_indices`` (its dataset shares them) keep the logits of its
classes. Video and zero-shot evaluation are not ported yet (they wait for
their model families)."""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from cvnets_tpu_torch.engine.train_state import TrainState, make_eval_step
from cvnets_tpu_torch.engine.training_engine import to_device
from cvnets_tpu_torch.metrics.stats import Statistics, add_pairs, pairs_to_host
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.checkpoint_utils import load_file


class Evaluator:
    def __init__(self, opts, model: nn.Module, test_loader, criteria=None,
                 checkpoint: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.opts = opts
        self.test_loader = test_loader
        self.device = torch.device(device if device is not None else "cuda")
        if checkpoint is not None:
            model.load_state_dict(load_file(checkpoint))
        self.state = TrainState(model=model.to(self.device), optimizer=None)
        if criteria is None:
            from cvnets_tpu_torch.loss import build_loss_fn

            criteria = build_loss_fn(opts)
        self.stats = Statistics(opts, getattr(opts, "stats.val", ["loss"]))
        subset = getattr(opts, "stats.logit_subset_indices", None)
        self._eval_step = make_eval_step(
            model, criteria, self.stats.metrics, opts=opts,
            logit_subset=torch.tensor(subset, device=self.device) if subset else None)

    def eval_fn_image(self) -> Dict[str, float]:
        start = time.time()
        pairs = None
        for batch in self.test_loader:
            pairs = add_pairs(pairs, self._eval_step(self.state, to_device(batch, self.device)))
        if pairs is not None:
            self.stats.update(pairs_to_host(pairs))
        self.stats.epoch_summary(0, stage="evaluation")
        logger.info(f"Evaluation took {time.time() - start:.2f} seconds")
        return self.stats.avg_statistics_all()
