"""The weighted sum of losses (counterpart of cvnets_tpu/loss/composite_loss.py).

``loss.composite_loss`` is the yaml's list of entries, each with a
``loss_category``, a ``loss_weight`` and that loss's nested config. Each
entry's loss is built from a copy of the options with the entry's config
flattened under ``loss.`` (``loss.<category>.name`` picks it; a category
with one loss, such as ``neural_augmentation``, is its own name). The loss
returns ``{category: value, ..., "total_loss": Σ weight · value}``, a dict
loss counting by its own ``total_loss``. Each entry keeps its own route: a
segmentation entry takes the fused seg-CE kernels as it does alone."""

from __future__ import annotations

import argparse
import copy
from typing import Any, Dict, Union

import torch

from cvnets_tpu_torch.loss import LOSS_REGISTRY
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria
from cvnets_tpu_torch.options.utils import flatten_yaml_as_dict
from cvnets_tpu_torch.utils import logger


@LOSS_REGISTRY.register(name="composite_loss", type="composite_loss")
class CompositeLoss(BaseCriteria):
    TAKES_DEVICE = True

    def __init__(self, opts, device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(opts)
        entries = getattr(opts, "loss.composite_loss", None)
        if not isinstance(entries, list) or not entries:
            logger.error("loss.composite_loss must be a non-empty list of loss entries")
        self.loss_fns: Dict[str, BaseCriteria] = {}
        self.loss_weights: Dict[str, float] = {}
        for entry in entries:
            entry = dict(entry)
            if "loss_category" not in entry or "loss_weight" not in entry:
                logger.error("each composite loss entry needs loss_category and loss_weight")
            category = entry.pop("loss_category")
            weight = float(entry.pop("loss_weight"))
            sub_opts = copy.copy(opts)
            for k, v in flatten_yaml_as_dict(entry).items():
                setattr(sub_opts, k if k.startswith("loss.") else f"loss.{k}", v)
            name = getattr(sub_opts, f"loss.{category}.name", None)
            if name is None:
                if (category, category) not in LOSS_REGISTRY:
                    logger.error(f"loss.{category}.name missing for composite entry")
                name = category
            cls = LOSS_REGISTRY[name, category]
            self.loss_fns[category] = (cls(sub_opts, device=device)
                                       if getattr(cls, "TAKES_DEVICE", False) else cls(sub_opts))
            self.loss_weights[category] = weight

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--loss.composite-loss", type=str, default=None,
                           help="List of loss entries; set via yaml (loss.composite_loss)")
        return parser

    def __call__(self, input_sample: Any, prediction: Any, target: Any,
                 **kwargs) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        total = 0.0
        for category, fn in self.loss_fns.items():
            value = fn(input_sample, prediction, target, **kwargs)
            if isinstance(value, dict):
                value = value["total_loss"]
            out[category] = value
            total = total + self.loss_weights[category] * value
        out["total_loss"] = total
        return out
