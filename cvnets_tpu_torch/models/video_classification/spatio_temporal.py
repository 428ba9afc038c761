"""Spatio-temporal video classification (counterpart of
cvnets_tpu/models/video_classification/spatio_temporal.py).

A clip is (B, T, C, H, W). A MobileViT encoder (``mobilevit``,
``mobilevit_v2``) runs frame by frame through ``extract_features_temporal``:
each MobileViT block attends to its own post-norm patches of the previous
frame (none on frame 0), and each frame's features are mean-pooled over
space. Any other encoder takes the frames folded into the batch through
``extract_features``, with no mixing along time. The frames' features are
averaged, then the ``classifier`` linear layer gives the logits (:52-101).
The encoder's own classifier is never called, so it is not built (the JAX
tree has none). The model's n_classes is
``--model.video-classification.n-classes``, which it writes into
``model.classification.n_classes`` as JAX does. Several clips of a video
are folded into the batch and voted over by the evaluation
(``engine.train_state.make_video_eval_step``).
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.models import MODEL_REGISTRY


@MODEL_REGISTRY.register(name="__base__", type="video_classification")
class BaseVideoEncoder(nn.Module):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseVideoEncoder:
            return parser
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.video-classification.name", type=str, default=None)
        group.add_argument("--model.video-classification.n-classes", type=int, default=400)
        group.add_argument("--model.video-classification.pretrained", type=str, default=None)
        group.add_argument("--model.video-classification.clip-out-voting-fn", type=str,
                           default="sum", choices=["sum", "max"])
        group.add_argument("--model.video-classification.inference-mode",
                           action="store_true")
        return parser

    @classmethod
    def build_model(cls, opts) -> "BaseVideoEncoder":
        return cls(opts)

    @staticmethod
    def get_lr_multipliers(opts) -> Dict[str, float]:
        return {}


@MODEL_REGISTRY.register(name="spatio_temporal", type="video_classification")
class SpatioTemporalEncoder(BaseVideoEncoder):
    def __init__(self, opts) -> None:
        super().__init__()
        n_classes = getattr(opts, "model.video_classification.n_classes", 400)
        setattr(opts, "model.classification.n_classes", n_classes)
        name = getattr(opts, "model.classification.name", "") or ""
        self.encoder = MODEL_REGISTRY[name, "classification"].build_model(opts)
        self.encoder.classifier = None
        self.temporal = "mobilevit" in name
        conf = self.encoder.model_conf_dict
        width = conf.get("exp_before_cls", conf["layer5"])["out"]
        self.classifier = LinearLayer(width, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C, H, W) → (B, n_classes)."""
        b, t = x.shape[:2]
        if self.temporal:
            prev, per_frame = None, []
            for i in range(t):
                feats, prev = self.encoder.extract_features_temporal(x[:, i], prev)
                per_frame.append(feats.mean(dim=(2, 3)))
            feats = torch.stack(per_frame, dim=1).mean(dim=1)
        else:
            feats = self.encoder.extract_features(x.flatten(0, 1))
            if feats.dim() == 4:  # a ViT gives its (B·T, E) embedding already
                feats = feats.mean(dim=(2, 3))
            feats = feats.reshape(b, t, -1).mean(dim=1)
        return self.classifier(feats)
