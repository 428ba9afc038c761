"""ResNet (counterpart of cvnets_tpu/models/classification/resnet.py): depths
18, 34, 50 and 101, SE variants, per-block dropout and stochastic depth.

CVNets' stem: a 3×3 stride-2 conv (``conv_1``), then a 3×3 stride-2
depthwise conv (``layer_1``) where the classic ResNet has its max pool; then
four stages of blocks (``layer_2`` .. ``layer_5``, one ``nn.Sequential`` each,
so the flax scopes ``layer_<i>_<j>`` load by rule) and the classifier. Each
block's stochastic-depth probability grows linearly over all blocks, from 0
to ``--model.classification.resnet.stochastic-depth-prob``. An
``output_stride`` of 8 or 16 turns the stride of layer_4 and layer_5, or of
layer_5, into dilation.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import (
    BaseImageEncoder,
    Classifier,
    dilates,
)
from cvnets_tpu_torch.models.classification.config.resnet import get_configuration
from cvnets_tpu_torch.modules.resnet_modules import BasicResNetBlock, BottleneckResNetBlock

_EXPANSION = {"basic": 1, "bottleneck": 4}


def stochastic_depth_schedule(sd_prob: float, n_blocks: int) -> List[float]:
    """Each block's drop probability: ``sd_prob · i / (n - 1)`` for block i of n."""
    return [sd_prob * i / max(n_blocks - 1, 1) for i in range(n_blocks)]


@MODEL_REGISTRY.register(name="resnet", type="classification")
class ResNet(BaseImageEncoder):
    NEURAL_AUGMENTOR = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.resnet.depth", type=int, default=50)
        group.add_argument("--model.classification.resnet.stochastic-depth-prob",
                           type=float, default=0.0)
        group.add_argument("--model.classification.resnet.se-resnet",
                           action="store_true", default=False)
        group.add_argument("--model.classification.resnet.dropout", type=float,
                           default=0.0, help="per-block dropout")
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        super().__init__()
        cfg = get_configuration(opts)
        sd_prob = getattr(opts, "model.classification.resnet.stochastic_depth_prob",
                          0.0) or 0.0
        block_dropout = getattr(opts, "model.classification.resnet.dropout", 0.0) or 0.0
        self.conv_1 = ConvLayer2d(opts, 3, 64, kernel_size=3, stride=2)
        self.layer_1 = ConvLayer2d(opts, 64, 64, kernel_size=3, stride=2, groups=64)
        self.model_conf_dict = {"conv1": {"in": 3, "out": 64},
                                "layer1": {"in": 64, "out": 64}}
        n_blocks = sum(cfg[f"layer{i}"]["num_blocks"] for i in range(2, 6))
        schedule = iter(stochastic_depth_schedule(sd_prob, n_blocks))
        in_ch, dilation = 64, 1
        for li in range(2, 6):
            c = cfg[f"layer{li}"]
            block_cls = (BasicResNetBlock if c["block_type"] == "basic"
                         else BottleneckResNetBlock)
            out_ch = c["mid_channels"] * _EXPANSION[c["block_type"]]
            blocks, stage_in = [], in_ch
            for bi in range(c["num_blocks"]):
                stride = c["stride"] if bi == 0 else 1
                if stride == 2 and dilates(output_stride, li):
                    dilation *= stride
                    stride = 1
                blocks.append(block_cls(
                    opts, in_ch, c["mid_channels"], out_ch, stride=stride,
                    dilation=dilation, squeeze_channels=c.get("squeeze_channels"),
                    stochastic_depth_prob=next(schedule), dropout=block_dropout))
                in_ch = out_ch
            setattr(self, f"layer_{li}", nn.Sequential(*blocks))
            self.model_conf_dict[f"layer{li}"] = {"in": stage_in, "out": in_ch}
        self.model_conf_dict["exp_before_cls"] = {"in": in_ch, "out": in_ch}
        self.classifier = Classifier(opts, in_ch, self.n_classes(opts),
                                     dropout=self.classifier_dropout(opts))
