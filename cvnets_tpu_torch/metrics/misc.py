"""Loss and grad-norm metrics (counterpart of cvnets_tpu/metrics/misc.py:14-33).
Each counts 1 a batch, so its average is a mean over batches. A loss dict
flattens to ``loss.<part>``, its ``total_loss`` to ``loss``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cvnets_tpu_torch.metrics import METRICS_REGISTRY
from cvnets_tpu_torch.metrics.metric_base import AverageMetric


@METRICS_REGISTRY.register(name="loss")
class LossMetric(AverageMetric):
    def batch_values(self, prediction, target, extras=None
                     ) -> Dict[str, Tuple[torch.Tensor, float]]:
        loss = (extras or {})["loss"]
        if isinstance(loss, dict):
            return {("loss" if k == "total_loss" else f"loss.{k}"): (v.detach(), 1.0)
                    for k, v in loss.items()}
        return {"loss": (loss.detach(), 1.0)}


@METRICS_REGISTRY.register(name="grad_norm")
class GradNormMetric(AverageMetric):
    def batch_values(self, prediction, target, extras=None
                     ) -> Dict[str, Tuple[torch.Tensor, float]]:
        return {"grad_norm": ((extras or {})["grad_norm"].detach(), 1.0)}
