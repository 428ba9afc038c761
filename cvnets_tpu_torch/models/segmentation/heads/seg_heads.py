"""Segmentation heads (counterpart of cvnets_tpu/models/segmentation/heads/seg_heads.py):
DeepLabv3 (ASPP), PSPNet (pyramid pooling) and the simple head (a 3×3 conv),
each on ``out_l5`` (or ``out_l5_exp``) and followed by the 1×1 classifier.

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
from cvnets_tpu_torch.modules.pspnet_module import PSP


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

    @classmethod
    def build_model(cls, opts, enc_conf: Dict[str, Dict[str, int]]) -> "BaseSegHead":
        return cls(opts, enc_conf)

    @staticmethod
    def _in_channels(opts, enc_conf: Dict[str, Dict[str, int]]) -> int:
        use_l5_exp = getattr(opts, "model.segmentation.use_level5_exp", False)
        return enc_conf["exp_before_cls" if use_l5_exp else "layer5"]["out"]

    @staticmethod
    def _features(end_points: Dict[str, torch.Tensor]) -> torch.Tensor:
        return end_points.get("out_l5_exp", end_points["out_l5"])

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

    def __init__(self, opts, enc_conf: Dict[str, Dict[str, int]]) -> None:
        super().__init__(opts, enc_conf)
        out_ch = getattr(opts, "model.segmentation.deeplabv3.aspp_out_channels", 256)
        self.aspp = ASPP(
            opts, self._in_channels(opts, enc_conf), out_ch,
            atrous_rates=tuple(getattr(opts, "model.segmentation.deeplabv3.aspp_rates",
                                       [6, 12, 18])),
            is_sep_conv=getattr(opts, "model.segmentation.deeplabv3.aspp_sep_conv", False),
            dropout=getattr(opts, "model.segmentation.deeplabv3.aspp_dropout", 0.1))
        self._make_classifier(opts, out_ch)

    def forward(self, end_points: Dict[str, torch.Tensor]
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        return self._package(self._classify(self.aspp(self._features(end_points))),
                             end_points)


@MODEL_REGISTRY.register(name="pspnet", type="segmentation_head")
class PSPNet(BaseSegHead):
    """The pyramid pooling module on ``out_l5`` (or ``out_l5_exp``), then the
    classifier."""

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.segmentation.pspnet.psp-pool-sizes", type=int,
                           nargs="+", default=[1, 2, 3, 6])
        group.add_argument("--model.segmentation.pspnet.psp-out-channels", type=int,
                           default=512)
        group.add_argument("--model.segmentation.pspnet.psp-dropout", type=float,
                           default=0.1)
        return parser

    def __init__(self, opts, enc_conf: Dict[str, Dict[str, int]]) -> None:
        super().__init__(opts, enc_conf)
        out_ch = getattr(opts, "model.segmentation.pspnet.psp_out_channels", 512)
        self.psp = PSP(
            opts, self._in_channels(opts, enc_conf), out_ch,
            pool_sizes=tuple(getattr(opts, "model.segmentation.pspnet.psp_pool_sizes",
                                     [1, 2, 3, 6])),
            dropout=getattr(opts, "model.segmentation.pspnet.psp_dropout", 0.1))
        self._make_classifier(opts, out_ch)

    def forward(self, end_points: Dict[str, torch.Tensor]
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        return self._package(self._classify(self.psp(self._features(end_points))),
                             end_points)


@MODEL_REGISTRY.register(name="simple_seg_head", type="segmentation_head")
class SimpleSegHead(BaseSegHead):
    """A 3×3 conv + norm + act that keeps the width (``conv``), then the
    classifier."""

    def __init__(self, opts, enc_conf: Dict[str, Dict[str, int]]) -> None:
        super().__init__(opts, enc_conf)
        in_ch = self._in_channels(opts, enc_conf)
        self.conv = ConvLayer2d(opts, in_ch, in_ch, kernel_size=3)
        self._make_classifier(opts, in_ch)

    def forward(self, end_points: Dict[str, torch.Tensor]
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        return self._package(self._classify(self.conv(self._features(end_points))),
                             end_points)
