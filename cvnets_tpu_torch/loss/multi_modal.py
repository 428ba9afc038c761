"""CLIP's contrastive loss (counterpart of cvnets_tpu/loss/multi_modal.py).

In training: logits = logit_scale · image · textᵀ in float32 (the embeddings
cast first, autocast off), labels ``arange(B)``, the mean of the cross
entropies over images and over texts; a dict with ``total_loss``,
``image_loss`` and ``text_loss``. Outside training, or without text
embeddings, the loss is 0, as the JAX package and the reference return it,
so a checkpoint ranked by the validation loss sees a constant, and the
checkpoint manager's tie rule (``<=``: the later epoch wins) makes every
epoch the best. The loss runs inside a ``torch.profiler`` range named
``LOSS_RANGE``.

In a process group each rank gathers every rank's image and text embeddings
with a differentiable all-gather and scores its own rows against all of
them, its labels offset by rank · B (the reference's
``ddp_functional_utils`` scheme). Averaged over the ranks, the loss and its
gradient are the in-batch InfoNCE of the global batch that the JAX
package's one program computes (multi_modal.py:4-9).
"""

from __future__ import annotations

import argparse
from typing import Any

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from cvnets_tpu_torch import parallel
from cvnets_tpu_torch.loss import LOSS_REGISTRY
from cvnets_tpu_torch.loss.base_criteria import BaseCriteria
from cvnets_tpu_torch.parallel import all_gather_with_grad

LOSS_RANGE = "clip_contrastive_loss"


@LOSS_REGISTRY.register(name="__base__", type="multi_modal_image_text")
class BaseMultiModalLoss(BaseCriteria):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseMultiModalLoss:
            return parser
        group = parser.add_argument_group(title="Multi-modal loss arguments")
        group.add_argument("--loss.multi-modal-image-text.name", type=str,
                           default="contrastive_loss_clip")
        return parser


@LOSS_REGISTRY.register(name="contrastive_loss_clip", type="multi_modal_image_text")
class ContrastiveLossClip(BaseMultiModalLoss):
    def __call__(self, input_sample: Any, prediction: Any, target: Any, **kwargs):
        image, text = prediction["image"], prediction["text"]
        if text is None or not kwargs.get("training", True):
            return torch.zeros((), device=image.device)
        scale = prediction.get("logit_scale", 100.0)
        with record_function(LOSS_RANGE), torch.autocast(image.device.type, enabled=False):
            image, text = image.float(), text.float()
            all_image, all_text = all_gather_with_grad(image), all_gather_with_grad(text)
            labels = torch.arange(image.shape[0], device=image.device) \
                + parallel.data_index() * image.shape[0]
            logits = (scale * image) @ all_text.t()  # this rank's images against every text
            if parallel.data_size() > 1:  # this rank's texts against every image
                logits_t = ((scale * all_image) @ text.t()).t()
            else:
                logits_t = logits.t()
            loss_i = F.cross_entropy(logits, labels)
            loss_t = F.cross_entropy(logits_t, labels)
        return {"total_loss": 0.5 * (loss_i + loss_t), "image_loss": loss_i,
                "text_loss": loss_t}
