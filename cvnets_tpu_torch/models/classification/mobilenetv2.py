"""MobileNetV2 (counterpart of cvnets_tpu/models/classification/mobilenetv2.py):
a 32-channel 3×3 stride-2 stem (not width-scaled, as in the reference),
inverted-residual stages (layer_4 holds the table's rows layer4 and layer4_a,
layer_5 rows layer5 and layer5_a), a 1×1 expansion to
``make_divisible(1280 · max(1, width), 8)`` and the classifier, whose dropout,
when the flag leaves it 0, is ``min(0.2, 0.2 · width)``. An ``output_stride``
of 8 or 16 turns strides into dilation."""

from __future__ import annotations

import argparse
from typing import Optional

import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import (
    BaseImageEncoder,
    Classifier,
    dilates,
)
from cvnets_tpu_torch.models.classification.config.mobilenetv2 import get_configuration
from cvnets_tpu_torch.modules.inverted_residual import InvertedResidual
from cvnets_tpu_torch.utils.math_utils import bound_fn, make_divisible

# the table's rows of each stage
_STAGE_ROWS = {1: ["layer1"], 2: ["layer2"], 3: ["layer3"], 4: ["layer4", "layer4_a"],
               5: ["layer5", "layer5_a"]}


@MODEL_REGISTRY.register(name="mobilenetv2", type="classification")
class MobileNetV2(BaseImageEncoder):
    NEURAL_AUGMENTOR = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.mobilenetv2.width-multiplier",
                           type=float, default=1.0)
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        super().__init__()
        wm = getattr(opts, "model.classification.mobilenetv2.width_multiplier", 1.0)
        cfg = get_configuration(opts)
        in_ch = 32
        self.conv_1 = ConvLayer2d(opts, 3, in_ch, kernel_size=3, stride=2)
        self.model_conf_dict = {"conv1": {"in": 3, "out": in_ch}}
        dilation = 1
        for li, rows in _STAGE_ROWS.items():
            blocks, stage_in = [], in_ch
            for row in rows:
                c = cfg[row]
                out_ch = make_divisible(c["out_channels"] * wm, 8)
                for i in range(c["num_blocks"]):
                    stride = c["stride"] if i == 0 else 1
                    if stride == 2 and dilates(output_stride, li):
                        dilation *= stride
                        stride = 1
                    blocks.append(InvertedResidual(opts, in_ch, out_ch, stride=stride,
                                                   expand_ratio=c["expansion_ratio"],
                                                   dilation=dilation))
                    in_ch = out_ch
            setattr(self, f"layer_{li}", nn.Sequential(*blocks))
            self.model_conf_dict[f"layer{li}"] = {"in": stage_in, "out": in_ch}
        last_ch = make_divisible(1280 * max(1.0, wm), 8)
        self.conv_1x1_exp = ConvLayer2d(opts, in_ch, last_ch, kernel_size=1)
        self.model_conf_dict["exp_before_cls"] = {"in": in_ch, "out": last_ch}
        dropout = self.classifier_dropout(opts) or bound_fn(0.0, 0.2, round(0.2 * wm, 3))
        self.classifier = Classifier(opts, last_ch, self.n_classes(opts), dropout=dropout)
