"""MobileNetV3 small and large (counterpart of
cvnets_tpu/models/classification/mobilenetv3.py; arXiv:1905.02244): a
hard-swish 3×3 stride-2 stem, ``InvertedResidualSE`` stages with hard-swish
and SE (hard-sigmoid scale) where the table says so, a hard-swish 1×1
expansion to 6× the last width, and a two-layer head (pool → ``fc1`` +
hard-swish → dropout → ``fc2``). As in the JAX package and the reference,
every block takes a 3×3 depthwise conv: the table's kernel column is never
passed on."""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.pool import global_pool
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import (
    BaseImageEncoder,
    dilates,
)
from cvnets_tpu_torch.modules.inverted_residual import InvertedResidualSE
from cvnets_tpu_torch.quantization import quant_linear
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.math_utils import make_divisible


def get_configuration(opts) -> Dict:
    """Each stage's rows: kernel, expansion, out_channels, use_se, use_hs, stride."""
    mode = (getattr(opts, "model.classification.mobilenetv3.mode", "large")
            or "large").lower()
    cfg: Dict[str, List] = {}
    if mode == "small":
        cfg["layer_1"] = [[3, 1, 16, True, False, 2]]
        cfg["layer_2"] = [[3, 4.5, 24, False, False, 2]]
        cfg["layer_3"] = [[3, 3.67, 24, False, False, 1]]
        cfg["layer_4"] = [
            [5, 4, 40, True, True, 2], [5, 6, 40, True, True, 1],
            [5, 6, 40, True, True, 1], [5, 3, 48, True, True, 1],
            [5, 3, 48, True, True, 1],
        ]
        cfg["layer_5"] = [
            [5, 6, 96, True, True, 2], [5, 6, 96, True, True, 1],
            [5, 6, 96, True, True, 1],
        ]
        cfg["last_channels"] = 1024
    elif mode == "large":
        cfg["layer_1"] = [[3, 1, 16, False, False, 1]]
        cfg["layer_2"] = [[3, 4, 24, False, False, 2], [3, 3, 24, False, False, 1]]
        cfg["layer_3"] = [
            [5, 3, 40, True, False, 2], [5, 3, 40, True, False, 1],
            [5, 3, 40, True, False, 1],
        ]
        cfg["layer_4"] = [
            [3, 6, 80, False, True, 2], [3, 2.5, 80, False, True, 1],
            [3, 2.3, 80, False, True, 1], [3, 2.3, 80, False, True, 1],
            [3, 6, 112, True, True, 1], [3, 6, 112, True, True, 1],
        ]
        cfg["layer_5"] = [
            [5, 6, 160, True, True, 2], [5, 6, 160, True, True, 1],
            [5, 6, 160, True, True, 1],
        ]
        cfg["last_channels"] = 1280
    else:
        logger.error(f"MobileNetV3 mode must be small/large; got {mode}")
    return cfg


class MobileNetV3Classifier(nn.Module):
    def __init__(self, opts, in_features: int, hidden_dim: int, n_classes: int,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.pool_type = getattr(opts, "model.layer.global_pool", "mean")
        self.fc1 = quant_linear(opts, in_features, hidden_dim)
        self.act = build_act_layer(opts, "hard_swish")
        self.dropout = nn.Dropout(dropout)
        self.fc2 = quant_linear(opts, hidden_dim, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.fc1(global_pool(x, self.pool_type)))
        return self.fc2(self.dropout(x))


@MODEL_REGISTRY.register(name="mobilenetv3", type="classification")
class MobileNetV3(BaseImageEncoder):
    NEURAL_AUGMENTOR = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.mobilenetv3.mode", type=str,
                           default="large")
        group.add_argument("--model.classification.mobilenetv3.width-multiplier",
                           type=float, default=1.0)
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        super().__init__()
        cfg = get_configuration(opts)
        wm = getattr(opts, "model.classification.mobilenetv3.width_multiplier", 1.0)
        in_ch = make_divisible(16 * wm, 8)
        self.conv_1 = ConvLayer2d(opts, 3, in_ch, kernel_size=3, stride=2,
                                  act_name="hard_swish")
        self.model_conf_dict = {"conv1": {"in": 3, "out": in_ch}}
        dilation = 1
        for li in range(1, 6):
            blocks, stage_in = [], in_ch
            for _k, exp, out_c, use_se, use_hs, stride in cfg[f"layer_{li}"]:
                out_c = make_divisible(out_c * wm, 8)
                if stride == 2 and dilates(output_stride, li):
                    dilation *= stride
                    stride = 1
                blocks.append(InvertedResidualSE(
                    opts, in_ch, out_c, expand_ratio=exp, use_hs=use_hs, use_se=use_se,
                    stride=stride, kernel_size=3, dilation=dilation))
                in_ch = out_c
            setattr(self, f"layer_{li}", nn.Sequential(*blocks))
            self.model_conf_dict[f"layer{li}"] = {"in": stage_in, "out": in_ch}
        exp_ch = make_divisible(in_ch * 6, 8)
        self.conv_1x1_exp = ConvLayer2d(opts, in_ch, exp_ch, kernel_size=1,
                                        act_name="hard_swish")
        self.model_conf_dict["exp_before_cls"] = {"in": in_ch, "out": exp_ch}
        self.classifier = MobileNetV3Classifier(
            opts, exp_ch, make_divisible(cfg["last_channels"] * max(1.0, wm), 8),
            self.n_classes(opts), dropout=self.classifier_dropout(opts))
