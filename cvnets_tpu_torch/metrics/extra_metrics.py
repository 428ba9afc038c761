"""The remaining metrics (counterpart of cvnets_tpu/metrics/extra_metrics.py:17-60,
103-119), under the JAX package's names.

* ``psnr``: 20·log10(255) − 10·log10(max(mse, 1e-10)) of a batch, the mse of
  the prediction and target scaled by 255 (one value a batch, averaged over
  batches);
* ``average_precision``: the macro average precision (in %) over the classes
  that have a positive, from the epoch's scores and multi-hot (or class
  index) targets;
* ``confusion_matrix``: the accuracy (in %) on the diagonal of the epoch's
  confusion matrix;
* ``prob_hist``: the share of the epoch's rows in each of 10 bins of the
  largest probability (the rows softmaxed unless they already sum to 1).

The last three keep their rows (``GatherMetric``): each step gives its
predictions and targets as rows to gather, read back once an epoch (and
gathered over the ranks of a process group), then computed in numpy as JAX's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.metrics import METRICS_REGISTRY
from cvnets_tpu_torch.metrics.metric_base import AverageMetric
from cvnets_tpu_torch.metrics.retrieval import GatherMetric


@METRICS_REGISTRY.register(name="psnr")
class PSNRMetric(AverageMetric):
    def batch_values(self, prediction, target, extras=None
                     ) -> Dict[str, Tuple[torch.Tensor, float]]:
        prediction, target = self._select(prediction, target)
        mse = (((prediction.float() - target.float()) * 255.0) ** 2).mean()
        psnr = 20.0 * np.log10(255.0) - 10.0 * torch.log10(mse.clamp(min=1e-10))
        return {"psnr": (psnr.detach(), 1.0)}


class _RowsMetric(GatherMetric):
    """The epoch's predictions and targets, then ``from_rows`` on them."""

    def batch_values(self, prediction, target, extras=None
                     ) -> Dict[str, Tuple[torch.Tensor, None]]:
        prediction, target = self._select(prediction, target)
        if isinstance(prediction, dict):
            prediction = prediction.get("logits", next(iter(prediction.values())))
        return {"preds": (prediction.detach().float(), None),
                "targets": (target.detach(), None)}

    def compute(self):
        if "preds" not in self._rows:
            return 0.0
        return self.from_rows(self.gathered("preds"), self.gathered("targets"))

    def from_rows(self, preds: np.ndarray, targets: np.ndarray):
        raise NotImplementedError


@METRICS_REGISTRY.register(name="average_precision")
class AveragePrecisionMetric(_RowsMetric):
    def from_rows(self, preds: np.ndarray, targets: np.ndarray) -> float:
        if targets.ndim == 1:
            targets = np.eye(preds.shape[-1])[targets.astype(int)]
        aps = []
        for c in range(preds.shape[-1]):
            t = targets[:, c]
            if t.sum() == 0:
                continue
            t_sorted = t[np.argsort(-preds[:, c])]
            precision = np.cumsum(t_sorted) / np.arange(1, len(t_sorted) + 1)
            aps.append(float((precision * t_sorted).sum() / t.sum()))
        return float(np.mean(aps) * 100) if aps else 0.0


@METRICS_REGISTRY.register(name="confusion_matrix")
class ConfusionMatrixMetric(_RowsMetric):
    def from_rows(self, preds: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
        if preds.ndim > 1:
            preds = preds.argmax(-1)
        n = int(max(preds.max(initial=0), targets.max(initial=0))) + 1
        cm = np.bincount(n * targets.astype(int) + preds.astype(int),
                         minlength=n * n).reshape(n, n)
        return {"accuracy": float(np.diag(cm).sum() / max(cm.sum(), 1) * 100)}


@METRICS_REGISTRY.register(name="prob_hist")
class ProbabilityHistogramMetric(_RowsMetric):
    n_bins = 10

    def from_rows(self, preds: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
        probs = preds
        if not np.allclose(probs.sum(-1), 1.0, atol=1e-2):
            e = np.exp(probs - probs.max(-1, keepdims=True))
            probs = e / e.sum(-1, keepdims=True)
        max_hist, _ = np.histogram(probs.max(-1), bins=self.n_bins, range=(0, 1))
        return {f"max_bin_{i}": float(v / max(1, len(probs))) for i, v in enumerate(max_hist)}
