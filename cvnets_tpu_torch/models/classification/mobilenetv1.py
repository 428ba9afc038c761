"""MobileNetV1 (counterpart of cvnets_tpu/models/classification/mobilenetv1.py):
a 3×3 stride-2 stem, then five stages of depthwise-separable convs
(arXiv:1704.04861). Widths are ``make_divisible(ceil(c · width), 16)``; the
classifier's dropout, when the flag leaves it 0, is ``min(0.1, 0.1 · width)``
as in the reference."""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d, SeparableConv2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import (
    BaseImageEncoder,
    Classifier,
    dilates,
)
from cvnets_tpu_torch.utils.math_utils import bound_fn, make_divisible


def get_configuration(opts) -> Dict:
    wm = getattr(opts, "model.classification.mobilenetv1.width_multiplier", 1.0)

    def c(ch):
        return make_divisible(int(math.ceil(ch * wm)), 16)

    return {
        "conv1_out": c(32),
        "layer1": {"out_channels": c(64), "stride": 1, "repeat": 1},
        "layer2": {"out_channels": c(128), "stride": 2, "repeat": 2},
        "layer3": {"out_channels": c(256), "stride": 2, "repeat": 2},
        "layer4": {"out_channels": c(512), "stride": 2, "repeat": 6},
        "layer5": {"out_channels": c(1024), "stride": 2, "repeat": 2},
    }


@MODEL_REGISTRY.register(name="mobilenetv1", type="classification")
class MobileNetV1(BaseImageEncoder):
    NEURAL_AUGMENTOR = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.mobilenetv1.width-multiplier",
                           type=float, default=1.0)
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        super().__init__()
        cfg = get_configuration(opts)
        in_ch = cfg["conv1_out"]
        self.conv_1 = ConvLayer2d(opts, 3, in_ch, kernel_size=3, stride=2)
        self.model_conf_dict = {"conv1": {"in": 3, "out": in_ch}}
        dilation = 1
        for li in range(1, 6):
            c = cfg[f"layer{li}"]
            blocks, stage_in = [], in_ch
            for bi in range(c["repeat"]):
                stride = c["stride"] if bi == 0 else 1
                if stride == 2 and dilates(output_stride, li):
                    dilation *= stride
                    stride = 1
                blocks.append(SeparableConv2d(opts, in_ch, c["out_channels"], 3,
                                              stride=stride, dilation=dilation))
                in_ch = c["out_channels"]
            setattr(self, f"layer_{li}", nn.Sequential(*blocks))
            self.model_conf_dict[f"layer{li}"] = {"in": stage_in, "out": in_ch}
        self.model_conf_dict["exp_before_cls"] = {"in": in_ch, "out": in_ch}
        wm = getattr(opts, "model.classification.mobilenetv1.width_multiplier", 1.0)
        dropout = self.classifier_dropout(opts) or bound_fn(0.0, 0.1, round(0.1 * wm, 3))
        self.classifier = Classifier(opts, in_ch, self.n_classes(opts), dropout=dropout)
