"""MobileViTv2 (counterpart of cvnets_tpu/models/classification/mobilevit_v2.py):
MV2 stages, then MobileViTBlockv2 separable-attention stages, then GlobalPool +
Linear. Module attributes carry the flax scope names, so
``utils.jax_params.load_jax_params`` can fill the model from a flax tree."""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import (
    BaseImageEncoder,
    Classifier,
)
from cvnets_tpu_torch.models.classification.config.mobilevit_v2 import get_configuration
from cvnets_tpu_torch.modules.inverted_residual import InvertedResidual
from cvnets_tpu_torch.modules.mobilevit_block import MobileViTBlockv2


@MODEL_REGISTRY.register(name="mobilevit_v2", type="classification")
class MobileViTv2(BaseImageEncoder):
    NEURAL_AUGMENTOR = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.mitv2.attn-dropout", type=float,
                           default=0.0)
        group.add_argument("--model.classification.mitv2.ffn-dropout", type=float,
                           default=0.0)
        group.add_argument("--model.classification.mitv2.dropout", type=float,
                           default=0.0)
        group.add_argument("--model.classification.mitv2.width-multiplier",
                           type=float, default=1.0)
        group.add_argument("--model.classification.mitv2.attn-norm-layer", type=str,
                           default="layer_norm_2d")
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        """``output_stride`` 8 dilates layer_4 and layer_5, 16 layer_5 only
        (mobilevit_v2.py:93-106): a dilated stage's first InvertedResidual runs
        at stride 1 with the previous dilation, its MobileViTBlockv2 at the new."""
        super().__init__()
        cfg = get_configuration(opts)
        in_ch = cfg["layer0"]["out_channels"]
        self.conv_1 = ConvLayer2d(opts, 3, in_ch, kernel_size=3, stride=2)
        # stage widths, as the JAX model_conf_dict: the segmentation heads read them
        self.model_conf_dict = {"conv1": {"in": 3, "out": in_ch}}
        dilated = {8: (4, 5), 16: (5,)}.get(output_stride, ())
        dilation = 1
        for idx in range(1, 6):
            stage_in = in_ch
            stage, in_ch, dilation = self._make_stage(opts, cfg[f"layer{idx}"], in_ch,
                                                      dilation, idx in dilated)
            setattr(self, f"layer_{idx}", stage)
            self.model_conf_dict[f"layer{idx}"] = {"in": stage_in, "out": in_ch}
        self.model_conf_dict["exp_before_cls"] = {"in": in_ch, "out": in_ch}
        self.classifier = Classifier(
            opts, in_ch, getattr(opts, "model.classification.n_classes", 1000),
            dropout=getattr(opts, "model.classification.classifier_dropout", 0.0) or 0.0)

    @staticmethod
    def _make_stage(opts, cfg: Dict, in_ch: int, dilation: int, dilate: bool
                    ) -> Tuple[nn.Sequential, int, int]:
        blocks = []
        if cfg.get("block_type", "mobilevit") != "mobilevit":
            out_ch = cfg["out_channels"]
            for i in range(cfg.get("num_blocks", 2)):
                blocks.append(InvertedResidual(
                    opts, in_ch, out_ch, stride=cfg.get("stride", 1) if i == 0 else 1,
                    expand_ratio=cfg.get("expand_ratio", 4)))
                in_ch = out_ch
            return nn.Sequential(*blocks), in_ch, dilation

        stride, prev_dilation = cfg.get("stride", 1), dilation
        if stride == 2:
            if dilate:
                dilation, stride = dilation * 2, 1
            blocks.append(InvertedResidual(
                opts, in_ch, cfg["out_channels"], stride=stride,
                expand_ratio=cfg.get("mv_expand_ratio", 4), dilation=prev_dilation))
            in_ch = cfg["out_channels"]
        blocks.append(MobileViTBlockv2(
            opts, in_ch, cfg["attn_unit_dim"],
            ffn_multiplier=cfg.get("ffn_multiplier", 2.0),
            n_attn_blocks=cfg.get("attn_blocks", 1),
            attn_dropout=getattr(opts, "model.classification.mitv2.attn_dropout", 0.0),
            dropout=getattr(opts, "model.classification.mitv2.dropout", 0.0),
            ffn_dropout=getattr(opts, "model.classification.mitv2.ffn_dropout", 0.0),
            patch_h=cfg.get("patch_h", 2), patch_w=cfg.get("patch_w", 2),
            conv_ksize=3, dilation=dilation,
            attn_norm_layer=getattr(opts, "model.classification.mitv2.attn_norm_layer",
                                    "layer_norm_2d")))
        return nn.Sequential(*blocks), in_ch, dilation
