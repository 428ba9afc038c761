"""Metric base classes (counterpart of cvnets_tpu/metrics/metric_base.py:23-100).

An ``AverageMetric`` turns a step's outputs into ``batch_values``: {name: (sum,
count)}, the sum a tensor on the step's device and the count a Python float,
so that the Trainer can add a step's pairs to a running total without reading
anything back. ``update_values`` takes those pairs once they are on the host
and ``compute`` gives sum / count. The JAX ``EpochMetric``'s role (rows
kept over an epoch) is ``metrics/retrieval.py``'s ``GatherMetric``, whose
rows stay on the device until the epoch's one read-back.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch


class BaseMetric:
    def __init__(self, opts=None, pred: Optional[str] = None,
                 target: Optional[str] = None, **kwargs) -> None:
        self.opts = opts
        self.pred_key = pred  # set by registry key arguments, e.g. top1(pred=logits)
        self.target_key = target
        self.reset()

    def _select(self, prediction: Any, target: Any) -> Tuple[Any, Any]:
        if self.pred_key and isinstance(prediction, dict):
            prediction = prediction[self.pred_key]
        if self.target_key and isinstance(target, dict):
            target = target[self.target_key]
        return prediction, target

    def reset(self) -> None:
        raise NotImplementedError

    def compute(self) -> Union[float, Dict[str, float]]:
        raise NotImplementedError


class AverageMetric(BaseMetric):
    def reset(self) -> None:
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, float] = {}

    def batch_values(self, prediction: Any, target: Any, extras: Optional[Dict] = None
                     ) -> Dict[str, Tuple[torch.Tensor, float]]:
        raise NotImplementedError

    def update_values(self, values: Dict[str, Tuple[float, float]]) -> None:
        """Add (sum, count) pairs that are already on the host."""
        for name, (vsum, cnt) in values.items():
            self._sums[name] = self._sums.get(name, 0.0) + float(vsum)
            self._counts[name] = self._counts.get(name, 0.0) + float(cnt)

    def compute(self) -> Union[float, Dict[str, float]]:
        out = {name: (self._sums[name] / self._counts[name]) if self._counts[name] else 0.0
               for name in self._sums}
        if len(out) == 1:
            return next(iter(out.values()))
        return out
