"""CLIP (counterpart of cvnets_tpu/models/multi_modal/clip.py).

The image tower is the registered classification model without its
classifier: its ``extract_features`` (the stages of a conv encoder; a ViT's
class embedding after ``post_transformer_norm``), then the projection head
(``--model.image-projection-head.name``, default ``global_pool_nchw2nc``).
The text tower is the registered text encoder; ``logit_scale`` is a float32
scalar at log(1/0.07). Both embeddings are L2-normalized, the norm in float32.

The JAX CLIP calls ``extract_features`` of the base encoder on every
encoder, which for a ViT (or a Swin) runs none of its blocks (it has no
``conv_1`` … ``conv_1x1_exp``), so the raw image is mean-pooled and
projected there. Here a ViT runs: its class embedding is what its
classifier would take (a Swin's pooled map), and the head projects it (the
reference puts the projection head in the classifier's place). The classifier is never called, so the model holds
none: it is not in the optimizer.

``encode_image`` and ``encode_text`` run inside ``torch.profiler`` ranges
named ``IMAGE_TOWER`` and ``TEXT_TOWER``, so a profile can sum each tower's
kernels (its backward's through the autograd sequence numbers of the ops in
the range). ``forward({"image", "text"})`` returns ``{"image", "text", "logit_scale"}``
(``logit_scale`` as exp of the parameter); with a 2-D float ``text`` (class
embeddings) it adds ``zero_shot_image_logits`` = 100·image·textᵀ.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
from torch.profiler import record_function

from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.multi_modal.base_multi_modal import BaseMultiModalImageText
from cvnets_tpu_torch.models.multi_modal.image_projection import (
    build_image_projection_head,
)
from cvnets_tpu_torch.models.multi_modal.image_projection.heads import l2_normalize
from cvnets_tpu_torch.models.multi_modal.text_encoders import build_text_encoder

IMAGE_TOWER, TEXT_TOWER = "clip_image_tower", "clip_text_tower"


def _feature_dim(encoder: nn.Module) -> int:
    """Channels of ``extract_features``: the classifier's input width."""
    conf = getattr(encoder, "model_conf_dict", None)
    if conf and "exp_before_cls" in conf:
        return conf["exp_before_cls"]["out"]
    classifier = encoder.classifier
    return getattr(classifier, "fc", classifier).in_features


@MODEL_REGISTRY.register(name="clip", type="multi_modal_image_text")
class CLIP(BaseMultiModalImageText):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.multi-modal-image-text.clip.projection-dim", type=int,
                           default=256)
        return parser

    def __init__(self, opts) -> None:
        super().__init__()
        dim = getattr(opts, "model.multi_modal_image_text.clip.projection_dim", 256)
        name = getattr(opts, "model.classification.name")
        self.image_encoder = MODEL_REGISTRY[name, "classification"].build_model(opts)
        in_dim = _feature_dim(self.image_encoder)
        self.image_encoder.classifier = nn.Identity()
        self.image_projection = build_image_projection_head(opts, in_dim, dim)
        self.text_encoder = build_text_encoder(opts, projection_dim=dim)
        self.logit_scale = nn.Parameter(torch.empty((), dtype=torch.float32))

    def init_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.logit_scale.fill_(math.log(1.0 / 0.07))

    @staticmethod
    def get_lr_multipliers(opts) -> Dict[str, float]:
        """Each tower's LR multiplier (base_multi_modal_img_text.py:21-25), by
        the regex the optimizer searches in a parameter's ``/``-joined name."""
        mults = {}
        for tower, flag in (("image_encoder", "img_encoder"), ("text_encoder", "text_encoder")):
            m = getattr(opts, f"model.multi_modal_image_text.lr_multiplier_{flag}", 1.0)
            if m and m != 1.0:
                mults[f"^{tower}/"] = float(m)
        return mults

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        with record_function(IMAGE_TOWER):
            feats = self.image_projection(self.image_encoder.extract_features(image))
            return l2_normalize(feats)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        with record_function(TEXT_TOWER):
            return l2_normalize(self.text_encoder(text))

    def forward(self, input_dict) -> Dict[str, Optional[torch.Tensor]]:
        if isinstance(input_dict, dict):
            image, text = input_dict.get("image"), input_dict.get("text")
        else:
            image, text = input_dict, None
        out = {"image": self.encode_image(image) if image is not None else None,
               "text": None, "logit_scale": self.logit_scale.exp()}
        if text is None:
            return out
        if text.dim() == 2 and text.is_floating_point():  # zero-shot class embeddings
            emb = out["image"]
            return {**out, "text": text,
                    "zero_shot_image_logits": 100.0 * emb @ text.t().to(emb.dtype)}
        return {**out, "text": self.encode_text(text)}
