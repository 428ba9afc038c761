"""Metrics registry and the stats flags (counterpart of cvnets_tpu/metrics/__init__.py).

A stats entry may carry registry key arguments, e.g. ``top1(pred=logits)``; the
metric is stored under its bare name."""

from __future__ import annotations

import argparse
from typing import Dict, Iterable

from cvnets_tpu_torch.metrics.metric_base import BaseMetric
from cvnets_tpu_torch.utils.registry import Registry

METRICS_REGISTRY = Registry(registry_name="metrics", base_class=BaseMetric)


def arguments_stats(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Statistics arguments")
    group.add_argument("--stats.val", type=str, nargs="+", default=["loss"])
    group.add_argument("--stats.train", type=str, nargs="+", default=["loss"])
    group.add_argument("--stats.checkpoint-metric", type=str, default="loss",
                       help="Metric (optionally metric.submetric) used to rank checkpoints")
    group.add_argument("--stats.checkpoint-metric-max", action="store_true",
                       default=False)
    group.add_argument("--stats.coco-map.iou-types", type=str, nargs="+", default=["bbox"],
                       help="IoU types of the COCO mAP (bbox; segm is not ported)")
    return parser


def build_metrics(opts, names: Iterable[str]) -> Dict[str, BaseMetric]:
    """One metric object for each stats entry, by its bare name."""
    return {METRICS_REGISTRY.parse_key(name)[0]: METRICS_REGISTRY[name](opts=opts)
            for name in names}


# registers the ported metrics (after METRICS_REGISTRY exists)
from cvnets_tpu_torch.metrics import (  # noqa: E402,F401
    coco_map,
    intersection_over_union,
    misc,
    retrieval,
    topk_accuracy,
)
