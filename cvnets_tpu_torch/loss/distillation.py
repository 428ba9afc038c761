"""Distillation losses (counterpart of cvnets_tpu/loss/distillation.py):
``soft_kl_loss`` (KL of the teacher's softmax to the student's at temperature
T, times T², in float32) and ``hard_distillation`` (CE against the teacher's
arg-max), under ``loss.category: distillation`` or as an entry of a composite
loss.

The teacher is a classification model built from the ``--teacher.model.*``
clones of the model flags (mapped back to ``model.*``, with the run's other
options) on the run's device, filled from
``--teacher.model.classification.pretrained`` (a checkpoint of the port;
another file raises as ``--common.finetune`` does). It is a constant of the
loss, as in the JAX package (distillation.py:53-55): in eval mode with no
grad, outside the student model and so outside its optimizer, EMA and
checkpoints. It runs under ``torch.no_grad()`` inside the step's autocast, on
the loss's ``input_sample``: the sample before the student's augmentor.
The teacher's forward runs inside a ``torch.profiler`` range named
``TEACHER_RANGE``, the loss's own arithmetic inside ``DISTILLATION_RANGE``."""

from __future__ import annotations

import argparse
from typing import Any, Union

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from cvnets_tpu_torch.loss import LOSS_REGISTRY
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria
from cvnets_tpu_torch.options.utils import extract_opts_with_prefix_replacement
from cvnets_tpu_torch.utils import logger

TEACHER_RANGE, DISTILLATION_RANGE = "distillation_teacher", "distillation_loss"


def build_teacher(opts, device: Union[str, torch.device] = "cuda") -> torch.nn.Module:
    """The frozen teacher of ``opts``' ``teacher.model.*`` options on ``device``."""
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.checkpoint_utils import finetune_weights

    teacher_opts = extract_opts_with_prefix_replacement(opts, "teacher.model.", "model.")
    for k, v in vars(opts).items():  # the options a model build reads besides model.*
        if not k.startswith("model.") and not hasattr(teacher_opts, k):
            setattr(teacher_opts, k, v)
    teacher = get_model(teacher_opts, category="classification", device=device)
    pretrained = getattr(teacher_opts, "model.classification.pretrained", None)
    if pretrained:
        teacher.load_state_dict(finetune_weights(
            teacher_opts, pretrained, teacher.state_dict(),
            flag="--teacher.model.classification.pretrained"))
        logger.info(f"Loaded the teacher's weights from {pretrained}")
    return teacher.eval().requires_grad_(False)


class BaseDistillationCriteria(BaseCriteria):
    TAKES_DEVICE = True

    def __init__(self, opts, device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(opts)
        self.teacher = build_teacher(opts, device)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseDistillationCriteria:
            return parser
        group = parser.add_argument_group(title="Distillation loss arguments")
        group.add_argument("--loss.distillation.name", type=str, default="soft_kl_loss")
        return parser

    @torch.no_grad()
    def teacher_logits(self, input_sample: torch.Tensor) -> torch.Tensor:
        with record_function(TEACHER_RANGE):
            out = self.teacher.eval()(input_sample)
        if isinstance(out, dict):
            out = out.get("logits", next(iter(out.values())))
        return out

    @staticmethod
    def student_logits(prediction: Any) -> torch.Tensor:
        return prediction["logits"] if isinstance(prediction, dict) else prediction


LOSS_REGISTRY.register(name="__base__", type="distillation")(BaseDistillationCriteria)


@LOSS_REGISTRY.register(name="soft_kl_loss", type="distillation")
class SoftKLLoss(BaseDistillationCriteria):
    def __init__(self, opts, device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(opts, device)
        self.temperature = getattr(
            opts, "loss.distillation.soft_kl_loss.temperature", 1.0) or 1.0

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--loss.distillation.soft-kl-loss.temperature", type=float,
                           default=1.0)
        return parser

    def __call__(self, input_sample: Any, prediction: Any, target: Any,
                 **kwargs) -> torch.Tensor:
        t, teacher = self.temperature, self.teacher_logits(input_sample)
        with record_function(DISTILLATION_RANGE):
            log_p = F.log_softmax(self.student_logits(prediction).float() / t, dim=-1)
            q = F.softmax(teacher.float() / t, dim=-1)
            kl = (q * (torch.log(q.clamp(min=1e-12)) - log_p)).sum(dim=-1)
            return kl.mean() * (t * t)


@LOSS_REGISTRY.register(name="hard_distillation", type="distillation")
class HardDistillationLoss(BaseDistillationCriteria):
    def __call__(self, input_sample: Any, prediction: Any, target: Any,
                 **kwargs) -> torch.Tensor:
        teacher = self.teacher_logits(input_sample)
        with record_function(DISTILLATION_RANGE):
            return F.cross_entropy(self.student_logits(prediction).float(),
                                   teacher.argmax(dim=-1))
