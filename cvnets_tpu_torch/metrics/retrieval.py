"""Retrieval metrics over an epoch's embeddings (counterpart of
cvnets_tpu/metrics/extra_metrics.py:61-101).

Each step's ``batch_values`` gives rows to gather, not (sum, count) pairs:
``(tensor, None)``. ``stats.add_pairs`` keeps them on the device and
``stats.pairs_to_host`` reads them back with the other sums in its one copy,
so an epoch's embeddings cross to the host once, when its statistics are
read. ``update_values`` keeps the host rows; ``compute`` ranks them in numpy,
as the JAX metrics do.

* ``image_text_retrieval``: the image and text embeddings of the
  predictions that have text; recall@{1, 5, 10} in % of image → text
  (``i2t_r{k}``) and text → image (``t2i_r{k}``), the i-th image's caption
  being the i-th text.
* ``retrieval_cmc``: the prediction (or its ``pred`` key) and the target of
  each row; the share (in %) of rows whose most similar other row by dot
  product has the same target.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.metrics import METRICS_REGISTRY
from cvnets_tpu_torch.metrics.metric_base import BaseMetric


class GatherMetric(BaseMetric):
    """Rows gathered over an epoch, by name."""

    def reset(self) -> None:
        self._rows: Dict[str, List[np.ndarray]] = {}

    def update_values(self, values: Dict[str, Tuple[np.ndarray, None]]) -> None:
        for name, (rows, _) in values.items():
            self._rows.setdefault(name, []).append(np.asarray(rows))

    def gathered(self, name: str) -> np.ndarray:
        return np.concatenate(self._rows[name], axis=0)


@METRICS_REGISTRY.register(name="image_text_retrieval")
class ImageTextRetrievalMetric(GatherMetric):
    def batch_values(self, prediction, target, extras=None) -> Dict[str, Tuple[torch.Tensor, None]]:
        if not isinstance(prediction, dict) or prediction.get("text") is None:
            return {}
        return {"image": (prediction["image"].detach().float(), None),
                "text": (prediction["text"].detach().float(), None)}

    def compute(self) -> Dict[str, float]:
        if "image" not in self._rows:
            return {"i2t_r1": 0.0}
        sim = self.gathered("image") @ self.gathered("text").T
        out = {}
        for name, s in (("i2t", sim), ("t2i", sim.T)):
            ranks = (-s).argsort(axis=1)
            pos = (ranks == np.arange(s.shape[0])[:, None]).argmax(axis=1)
            for k in (1, 5, 10):
                out[f"{name}_r{k}"] = float((pos < k).mean() * 100)
        return out


@METRICS_REGISTRY.register(name="retrieval_cmc")
class RetrievalCMCMetric(GatherMetric):
    def batch_values(self, prediction, target, extras=None) -> Dict[str, Tuple[torch.Tensor, None]]:
        prediction, target = self._select(prediction, target)
        return {"preds": (prediction.detach().float(), None),
                "targets": (target.detach().float(), None)}

    def compute(self) -> float:
        if "preds" not in self._rows:
            return 0.0
        preds, targets = self.gathered("preds"), self.gathered("targets")
        sim = preds @ preds.T
        np.fill_diagonal(sim, -np.inf)
        return float((targets[sim.argmax(axis=1)] == targets).mean() * 100)
