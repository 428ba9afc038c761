"""Statistics over an epoch (counterpart of cvnets_tpu/metrics/stats.py:13-85).

The steps return each metric's (sum, count) pairs with the sums on the device
(a scalar, or a vector such as the IoU's per-class int64 counts).
``add_pairs`` adds a step's pairs to a running total there, and ``pairs_to_host``
reads a total back in one transfer; the Trainer calls it only at its log points
and at the end of an epoch. ``Statistics.update`` takes what it returns. A
pair whose count is None holds rows to gather (the retrieval metrics'
embeddings): ``add_pairs`` lists them on the device and ``pairs_to_host``
concatenates them into its one copy.

In a process group ``gathered_pairs`` reads a rank's total back and adds the
ranks' totals on the host (the rows concatenated in rank order), so that
every rank's ``Statistics`` see the global batch's, as the JAX package's
one program does. Every rank calls it at the same points (the Trainer's log
points and the ends of its epochs), with or without pairs of its own.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cvnets_tpu_torch import parallel
from cvnets_tpu_torch.metrics import build_metrics
from cvnets_tpu_torch.utils import logger

# {metric: {name: (sum, count)}}, or (rows, None) for rows to gather
Pairs = Dict[str, Dict[str, Tuple[torch.Tensor, Optional[float]]]]


def _add(prev: Tuple, new: Tuple) -> Tuple:
    if new[1] is None:  # rows: listed, concatenated in the read-back
        rows = prev[0] if isinstance(prev[0], list) else [prev[0]]
        return rows + [new[0]], None
    return prev[0] + new[0], prev[1] + new[1]


def add_pairs(total: Optional[Pairs], pairs: Pairs) -> Pairs:
    """``total + pairs``, name by name; the sums and rows stay on their device."""
    if total is None:
        return pairs
    out = {metric: dict(values) for metric, values in total.items()}
    for metric, values in pairs.items():
        dst = out.setdefault(metric, {})
        for name, new in values.items():
            dst[name] = _add(dst[name], new) if name in dst else new
    return out


def pairs_to_host(pairs: Pairs) -> Dict[str, Dict[str, Tuple[object, float]]]:
    """The same pairs with every sum on the host, read back in one copy: a
    scalar sum as a Python float, a vector sum (the IoU's per-class counts) as
    a float64 numpy array. The sums travel as float64, exact for int64 counts
    up to 2^53."""
    keys = [(metric, name) for metric, values in pairs.items() for name in values]

    def tensor(value):
        return torch.cat(value) if isinstance(value, list) else torch.as_tensor(value)

    sums = [tensor(pairs[m][n][0]) for m, n in keys]
    if not sums:
        return {metric: {} for metric in pairs}
    flat = torch.cat([s.reshape(-1).double() for s in sums]).cpu().numpy()
    out: Dict[str, Dict[str, Tuple[object, Optional[float]]]] = {metric: {} for metric in pairs}
    start = 0
    for (metric, name), s in zip(keys, sums):
        value = flat[start:start + s.numel()]
        start += s.numel()
        count = pairs[metric][name][1]
        out[metric][name] = (float(value[0]) if s.dim() == 0 else value.reshape(s.shape),
                             None if count is None else float(count))
    return out


HostPairs = Dict[str, Dict[str, Tuple[object, Optional[float]]]]


def merge_host_pairs(parts) -> HostPairs:
    """Host pairs added name by name: sums and counts summed, rows (count
    None) concatenated in order."""
    out: HostPairs = {}
    for part in parts:
        for metric, values in part.items():
            dst = out.setdefault(metric, {})
            for name, (value, count) in values.items():
                if name not in dst:
                    dst[name] = (value, count)
                elif count is None:
                    dst[name] = (np.concatenate([dst[name][0], value]), None)
                else:
                    dst[name] = (dst[name][0] + value, dst[name][1] + count)
    return out


def gathered_pairs(pairs: Optional[Pairs]) -> HostPairs:
    """``pairs`` (None: none) read back, and added over the ranks of a
    process group."""
    host = pairs_to_host(pairs) if pairs is not None else {}
    if parallel.data_size() == 1:
        return host
    return merge_host_pairs(parallel.all_gather_objects(host))


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
