"""Base of the classification backbones (counterpart of
cvnets_tpu/models/classification/base_image_encoder.py).

NCHW input; the five-stage skeleton ``conv_1, layer_1..layer_5, conv_1x1_exp,
classifier`` (a model without ``conv_1x1_exp`` goes from layer_5 to the
classifier), ``extract_features`` (the stages without the classifier: CLIP's
image features), and the tap points that the segmentation heads read
(``extract_end_points_all``).

Under ``--model.classification.gradient-checkpointing`` every stage runs
under ``layers.remat`` in training (base_image_encoder.py:123-127):
recomputed in the backward, with the loss, gradients and BN statistics of a
run without it. ``extract_features_temporal`` (:131-164) is the video
models' frame-by-frame forward: each MobileViT block cross-attends to its
own post-norm patches of the previous frame.

RangeAugment's neural augmentor (``--model.learn-augmentation.mode``) is
built by ``get_model`` into a model of a family whose ``NEURAL_AUGMENTOR`` is
set (the ten families whose JAX modules build one), only when it is the
top-level classification model: JAX runs the augmentor in the encoder's
``__call__`` alone (base_image_encoder.py:206-216), which segmentation,
detection and CLIP never call, so their encoders have no augmentor
parameters. In training such a model returns ``{"augmented_tensor",
"logits"}``, else its logits.

As in the JAX package, ``--model.classification.activation.*`` are parsed and
never read: the JAX package never calls its
``set_model_specific_opts_before_model_building`` (base_image_encoder.py:258),
so the layers build with ``--model.activation.*``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.pool import global_pool
from cvnets_tpu_torch.layers.remat import remat
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.quantization import quant_linear


def dilates(output_stride: Optional[int], stage: int) -> bool:
    """Whether stage 4 or 5 (output strides 16 and 32) turns its stride 2 into
    dilation for an encoder at ``output_stride`` (8 or 16; None: no stage)."""
    return output_stride is not None and {4: 16, 5: 32}.get(stage, 0) > output_stride


@MODEL_REGISTRY.register(name="__base__", type="classification")
class BaseImageEncoder(nn.Module):
    STAGES = ("conv_1", "layer_1", "layer_2", "layer_3", "layer_4", "layer_5")
    NEURAL_AUGMENTOR = False  # whether the family's JAX module builds the augmentor
    gradient_checkpointing = False  # --model.classification.gradient-checkpointing

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BaseImageEncoder:
            return parser
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.classifier-dropout", type=float,
                           default=0.0)
        group.add_argument("--model.classification.name", type=str, default=None)
        group.add_argument("--model.classification.n-classes", type=int, default=1000)
        group.add_argument("--model.classification.pretrained", type=str, default=None)
        group.add_argument("--model.classification.activation.name", type=str, default=None)
        group.add_argument("--model.classification.activation.inplace", action="store_true")
        group.add_argument("--model.classification.activation.neg-slope", type=float,
                           default=0.1)
        group.add_argument("--model.classification.gradient-checkpointing",
                           action="store_true",
                           help="Recompute each stage (ViT, Swin: each block) in the "
                                "backward instead of keeping its activations")
        return parser

    @classmethod
    def build_model(cls, opts, **kwargs) -> "BaseImageEncoder":
        """``kwargs``: e.g. ``output_stride`` for a segmentation encoder."""
        model = cls(opts, **kwargs)
        model.gradient_checkpointing = bool(
            getattr(opts, "model.classification.gradient_checkpointing", False))
        return model

    @staticmethod
    def n_classes(opts) -> int:
        return getattr(opts, "model.classification.n_classes", 1000)

    @staticmethod
    def classifier_dropout(opts) -> float:
        return getattr(opts, "model.classification.classifier_dropout", 0.0) or 0.0

    @staticmethod
    def get_lr_multipliers(opts) -> Dict[str, float]:
        """No per-parameter LR multipliers (layer-wise LR decay, the JAX
        encoders' only multiplier, is not ported)."""
        return {}

    def run_stage(self, stage: Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
        """``stage(x)``, under ``remat`` when checkpointing in training; a
        missing stage passes ``x`` through."""
        if stage is None:
            return x
        if self.gradient_checkpointing and self.training:
            return remat(stage, x)
        return stage(x)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """``conv_1`` … ``layer_5``, then ``conv_1x1_exp`` where the model has
        one (base_image_encoder.py:196-200)."""
        for name in self.STAGES + ("conv_1x1_exp",):
            x = self.run_stage(getattr(self, name, None), x)
        return x

    def extract_features_temporal(self, x: torch.Tensor,
                                  prev_patches: Optional[Dict[str, torch.Tensor]] = None
                                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One frame: the stages as ``extract_features``, each MobileViT block
        given the previous frame's patches under its key (``layer_4.1``: the
        stage and the block's place in it; None on the first frame), and
        returning its own. Returns (features, {key: patches})."""
        from cvnets_tpu_torch.modules.mobilevit_block import MobileViTBlock, MobileViTBlockv2

        prev = prev_patches or {}
        patches: Dict[str, torch.Tensor] = {}

        def run(module: Optional[nn.Module], h: torch.Tensor, key: str) -> torch.Tensor:
            if module is None:
                return h
            if isinstance(module, nn.Sequential):
                for i, m in enumerate(module):
                    h = run(m, h, f"{key}.{i}")
                return h
            if isinstance(module, (MobileViTBlock, MobileViTBlockv2)):
                h, patches[key] = module(h, x_prev=prev.get(key), return_patches=True)
                return h
            return module(h)

        for name in self.STAGES + ("conv_1x1_exp",):
            x = run(getattr(self, name, None), x, name)
        return x, patches

    def forward(self, x: torch.Tensor, augmentation_draws=None):
        """Logits; with a neural augmentor, in training, ``{"augmented_tensor",
        "logits"}`` with the augmentor's ``draws`` (drawn here when None)."""
        augmentor = self._modules.get("neural_augmentor")
        if augmentor is None:
            return self.classifier(self.extract_features(x))
        x = augmentor(x, augmentation_draws)
        logits = self.classifier(self.extract_features(x))
        return {"augmented_tensor": x, "logits": logits} if self.training else logits

    def extract_end_points_all(self, x: torch.Tensor, use_l5: bool = True,
                               use_l5_exp: bool = False) -> Dict[str, torch.Tensor]:
        """Features after layer_1..layer_5 as ``out_l1``..``out_l5``
        (base_image_encoder.py:167-191); ``out_l5_exp`` after ``conv_1x1_exp``,
        which a model without one passes through."""
        out: Dict[str, torch.Tensor] = {}
        x = self.run_stage(self.conv_1, x)
        for i in range(1, 6 if use_l5 else 5):
            x = self.run_stage(getattr(self, f"layer_{i}"), x)
            out[f"out_l{i}"] = x
        if use_l5 and use_l5_exp:
            out["out_l5_exp"] = self.run_stage(getattr(self, "conv_1x1_exp", None), x)
        return out

    def extract_end_points_l4(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.extract_end_points_all(x, use_l5=False)


class Classifier(nn.Module):
    """GlobalPool → Dropout → Linear head."""

    def __init__(self, opts, in_features: int, n_classes: int,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.pool_type = getattr(opts, "model.layer.global_pool", "mean")
        self.dropout = nn.Dropout(dropout)
        self.fc = quant_linear(opts, in_features, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.dropout(global_pool(x, self.pool_type)))
