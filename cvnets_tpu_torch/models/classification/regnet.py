"""RegNet X and Y (counterpart of cvnets_tpu/models/classification/regnet.py;
arXiv:2003.13678): a 3×3 stride-2 stem of ``stem-width`` channels, no layer_1
(an identity), four stages of ``XRegNetBlock`` (layer_2 .. layer_5) whose
widths, depths and group widths come from the mode's quantized linear rule
(``config/regnet.py``), stochastic depth growing linearly over the blocks,
and the classifier."""

from __future__ import annotations

import argparse
from typing import Optional

import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import (
    BaseImageEncoder,
    Classifier,
)
from cvnets_tpu_torch.models.classification.config.regnet import get_configuration
from cvnets_tpu_torch.models.classification.resnet import stochastic_depth_schedule
from cvnets_tpu_torch.modules.regnet_modules import XRegNetBlock


@MODEL_REGISTRY.register(name="regnet", type="classification")
class RegNet(BaseImageEncoder):
    NEURAL_AUGMENTOR = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.regnet.stem-width", type=int,
                           default=32)
        group.add_argument("--model.classification.regnet.mode", type=str,
                           default="y_400mf")
        group.add_argument("--model.classification.regnet.stochastic-depth-prob",
                           type=float, default=0.0)
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        super().__init__()
        cfg = get_configuration(opts)
        sd_prob = getattr(opts, "model.classification.regnet.stochastic_depth_prob",
                          0.0) or 0.0
        stem = getattr(opts, "model.classification.regnet.stem_width", 32) or 32
        self.conv_1 = ConvLayer2d(opts, 3, stem, kernel_size=3, stride=2)
        self.layer_1 = nn.Identity()
        self.model_conf_dict = {"conv1": {"in": 3, "out": stem},
                                "layer1": {"in": stem, "out": stem}}
        schedule = iter(stochastic_depth_schedule(
            sd_prob, sum(cfg[f"layer{i}"]["depth"] for i in range(1, 5))))
        in_ch = stem
        for li in range(1, 5):
            c = cfg[f"layer{li}"]
            blocks, stage_in = [], in_ch
            for bi in range(c["depth"]):
                blocks.append(XRegNetBlock(
                    opts, in_ch, c["width"], stride=c["stride"] if bi == 0 else 1,
                    group_width=c["groups"],
                    bottleneck_multiplier=c["bottleneck_multiplier"],
                    se_ratio=c["se_ratio"], stochastic_depth_prob=next(schedule)))
                in_ch = c["width"]
            setattr(self, f"layer_{li + 1}", nn.Sequential(*blocks))
            self.model_conf_dict[f"layer{li + 1}"] = {"in": stage_in, "out": in_ch}
        self.model_conf_dict["exp_before_cls"] = {"in": in_ch, "out": in_ch}
        self.classifier = Classifier(opts, in_ch, self.n_classes(opts),
                                     dropout=self.classifier_dropout(opts))
