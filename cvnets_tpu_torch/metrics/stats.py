"""Statistics over an epoch (counterpart of cvnets_tpu/metrics/stats.py:13-85).

The steps return each metric's (sum, count) pairs with the sums on the device
(a scalar, or a vector such as the IoU's per-class int64 counts).
``add_pairs`` adds a step's pairs to a running total there, and ``pairs_to_host``
reads a total back in one transfer; the Trainer calls it only at its log points
and at the end of an epoch. ``Statistics.update`` takes what it returns.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from cvnets_tpu_torch.metrics import build_metrics
from cvnets_tpu_torch.utils import logger

# {metric: {name: (sum, count)}}
Pairs = Dict[str, Dict[str, Tuple[torch.Tensor, float]]]


def add_pairs(total: Optional[Pairs], pairs: Pairs) -> Pairs:
    """``total + pairs``, name by name; the sums stay on their device."""
    if total is None:
        return pairs
    return {metric: {name: (total[metric][name][0] + s, total[metric][name][1] + c)
                     for name, (s, c) in values.items()}
            for metric, values in pairs.items()}


def pairs_to_host(pairs: Pairs) -> Dict[str, Dict[str, Tuple[object, float]]]:
    """The same pairs with every sum on the host, read back in one copy: a
    scalar sum as a Python float, a vector sum (the IoU's per-class counts) as
    a float64 numpy array. The sums travel as float64, exact for int64 counts
    up to 2^53."""
    keys = [(metric, name) for metric, values in pairs.items() for name in values]
    sums = [torch.as_tensor(pairs[m][n][0]) for m, n in keys]
    flat = torch.cat([s.reshape(-1).double() for s in sums]).cpu().numpy()
    out: Dict[str, Dict[str, Tuple[object, float]]] = {metric: {} for metric in pairs}
    start = 0
    for (metric, name), s in zip(keys, sums):
        value = flat[start:start + s.numel()]
        start += s.numel()
        out[metric][name] = (float(value[0]) if s.dim() == 0 else value.reshape(s.shape),
                             float(pairs[metric][name][1]))
    return out


class Statistics:
    def __init__(self, opts, metric_names) -> None:
        self.opts = opts
        self.metrics = build_metrics(opts, metric_names)
        self.batch_load_time = 0.0
        self.batch_counter = 0

    def update(self, precomputed: Dict[str, Dict[str, Tuple[float, float]]],
               batch_load_time: float = 0.0) -> None:
        """Add host (sum, count) pairs, by metric (``pairs_to_host``'s output)."""
        for name, metric in self.metrics.items():
            if name in precomputed:
                metric.update_values(precomputed[name])
        self.batch_load_time += batch_load_time
        self.batch_counter += 1

    def avg_statistics(self) -> Dict[str, object]:
        return {name: metric.compute() for name, metric in self.metrics.items()}

    def avg_statistics_all(self) -> Dict[str, float]:
        """Sub-metrics flattened to ``metric.sub`` keys (a key that already
        starts with the metric's name, as ``loss.seg_loss``, is kept)."""
        flat = {}
        for name, value in self.avg_statistics().items():
            if isinstance(value, dict):
                for k, v in value.items():
                    flat[k if k.startswith(name) else f"{name}.{k}"] = v
            else:
                flat[name] = value
        return flat

    def metric_value(self, metric_name: str) -> float:
        """A value for ranking checkpoints; takes ``metric.sub``, also where the
        sub-metric's own key is ``metric.sub`` (the loss parts), which the JAX
        ``metric_value`` misses."""
        parts = metric_name.split(".", 1)
        value = self.metrics[parts[0]].compute()
        if isinstance(value, dict):
            if len(parts) == 1:
                return float(next(iter(value.values())))
            return float(value[metric_name] if metric_name in value else value[parts[1]])
        return float(value)

    def iter_summary(self, epoch: int, n_processed_samples: int, total_samples: int,
                     epoch_start: float, learning_rate: float) -> None:
        stats = " || ".join(f"{k}: {v:.4f}" for k, v in self.avg_statistics_all().items())
        elapsed = time.time() - epoch_start
        logger.log(
            f"Epoch: {epoch:3d} [{n_processed_samples:8d}/{total_samples:8d}] || "
            f"{stats} || LR: {learning_rate:.6f} || Avg. batch load time: "
            f"{self.batch_load_time / max(self.batch_counter, 1):.3f} || "
            f"Elapsed time: {elapsed:.2f}")

    def epoch_summary(self, epoch: int, stage: str = "training") -> None:
        stats = " || ".join(f"{k}: {v:.4f}" for k, v in self.avg_statistics_all().items())
        logger.log(f"*** {stage.title()} summary for epoch {epoch}: {stats}")
