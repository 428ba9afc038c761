"""Top-k accuracy (counterpart of cvnets_tpu/metrics/topk_accuracy.py:13-48)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cvnets_tpu_torch.metrics import METRICS_REGISTRY
from cvnets_tpu_torch.metrics.metric_base import AverageMetric


def top_k_correct(logits: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    """The number of rows whose target's logit has fewer than ``k`` logits
    strictly greater than it, as a float tensor on the logits' device. A tie
    with the target's logit counts for the target, unlike ``torch.topk``, which
    may rank a tied class first. Soft targets (mixup) are arg-maxed."""
    if target.dim() == logits.dim():
        target = target.argmax(dim=-1)
    k = min(k, logits.shape[-1])
    target_logit = logits.gather(-1, target.unsqueeze(-1))
    rank = (logits > target_logit).sum(dim=-1)
    return (rank < k).float().sum()


class _TopK(AverageMetric):
    k: int = 1

    def batch_values(self, prediction, target, extras=None
                     ) -> Dict[str, Tuple[torch.Tensor, float]]:
        prediction, target = self._select(prediction, target)
        if isinstance(prediction, dict):
            prediction = prediction.get("logits", next(iter(prediction.values())))
        correct = top_k_correct(prediction, target, self.k)
        return {f"top{self.k}": (correct * 100.0, float(prediction.shape[0]))}


@METRICS_REGISTRY.register(name="top1")
class Top1Accuracy(_TopK):
    k = 1


@METRICS_REGISTRY.register(name="top5")
class Top5Accuracy(_TopK):
    k = 5
