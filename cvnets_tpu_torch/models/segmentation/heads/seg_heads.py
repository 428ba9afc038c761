"""Segmentation heads (counterpart of cvnets_tpu/models/segmentation/heads/seg_heads.py).
Only DeepLabv3 is ported; PSPNet and the simple head are not registered yet.

A head takes the encoder's tap points and returns head-resolution NCHW logits;
in training with ``--model.segmentation.use-aux-head`` it returns
``{"segmentation_output", "aux_output"}``, the aux branch reading ``out_l4``.
Submodules carry the flax scope names."""

from __future__ import annotations

import argparse
from typing import Dict, Union

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.modules.aspp_block import ASPP


class BaseSegHead(nn.Module):
    """``enc_conf`` is the encoder's ``model_conf_dict`` (stage widths)."""

    def __init__(self, opts, enc_conf: Dict[str, Dict[str, int]]) -> None:
        super().__init__()
        self.n_seg_classes = getattr(opts, "model.segmentation.n_classes", 21)
        self.use_aux_head = getattr(opts, "model.segmentation.use_aux_head", False)
        if self.use_aux_head:  # seg_heads.py:31-41
            l4 = enc_conf["layer4"]["out"]
            aux_ch = l4 // 2 or 128
            self.aux_conv = ConvLayer2d(opts, l4, aux_ch, kernel_size=3)
            self.aux_dropout = nn.Dropout(getattr(opts, "model.segmentation.aux_dropout", 0.1))
            self.aux_classifier = ConvLayer2d(opts, aux_ch, self.n_seg_classes, kernel_size=1,
                                              use_norm=False, use_act=False, bias=True)

    def _make_classifier(self, opts, in_channels: int) -> None:
        self.classifier_dropout = nn.Dropout(
            getattr(opts, "model.segmentation.classifier_dropout", 0.1))
        self.classifier = ConvLayer2d(opts, in_channels, self.n_seg_classes, kernel_size=1,
                                      use_norm=False, use_act=False, bias=True)

    def _classify(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.classifier_dropout(x))

    def _package(self, logits: torch.Tensor, end_points: Dict[str, torch.Tensor]
                 ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        """The aux output only in training (seg_heads.py:51-58)."""
        if self.use_aux_head and self.training:
            aux = self.aux_classifier(self.aux_dropout(self.aux_conv(end_points["out_l4"])))
            return {"segmentation_output": logits, "aux_output": aux}
        return logits


MODEL_REGISTRY.register(name="__base__", type="segmentation_head")(BaseSegHead)


@MODEL_REGISTRY.register(name="deeplabv3", type="segmentation_head")
class DeeplabV3(BaseSegHead):
    """ASPP on ``out_l5`` (or ``out_l5_exp``), then the classifier."""

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.segmentation.deeplabv3.aspp-rates", type=int,
                           nargs="+", default=[6, 12, 18])
        group.add_argument("--model.segmentation.deeplabv3.aspp-out-channels",
                           type=int, default=256)
        group.add_argument("--model.segmentation.deeplabv3.aspp-sep-conv",
                           action="store_true")
        group.add_argument("--model.segmentation.deeplabv3.aspp-dropout",
                           type=float, default=0.1)
        return parser

    @classmethod
    def build_model(cls, opts, enc_conf: Dict[str, Dict[str, int]]) -> "DeeplabV3":
        return cls(opts, enc_conf)

    def __init__(self, opts, enc_conf: Dict[str, Dict[str, int]]) -> None:
        super().__init__(opts, enc_conf)
        use_l5_exp = getattr(opts, "model.segmentation.use_level5_exp", False)
        in_ch = enc_conf["exp_before_cls" if use_l5_exp else "layer5"]["out"]
        out_ch = getattr(opts, "model.segmentation.deeplabv3.aspp_out_channels", 256)
        self.aspp = ASPP(
            opts, in_ch, out_ch,
            atrous_rates=tuple(getattr(opts, "model.segmentation.deeplabv3.aspp_rates",
                                       [6, 12, 18])),
            is_sep_conv=getattr(opts, "model.segmentation.deeplabv3.aspp_sep_conv", False),
            dropout=getattr(opts, "model.segmentation.deeplabv3.aspp_dropout", 0.1))
        self._make_classifier(opts, out_ch)

    def forward(self, end_points: Dict[str, torch.Tensor]
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self.aspp(end_points.get("out_l5_exp", end_points["out_l5"]))
        return self._package(self._classify(x), end_points)
