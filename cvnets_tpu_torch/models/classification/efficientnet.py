"""EfficientNet b0-b8 (counterpart of cvnets_tpu/models/classification/efficientnet.py;
arXiv:1905.11946): B0's table scaled by each mode's width and depth
multipliers, ``InvertedResidualSE`` blocks with swish, SE (sigmoid scale,
squeezed by 4 × the expansion) and stochastic depth growing linearly over the
blocks, a 1×1 expansion and the classifier. The table's rows map onto the
five-stage skeleton as in the JAX package (layer_4 holds rows 3-4, layer_5
rows 5-6)."""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import (
    BaseImageEncoder,
    Classifier,
    dilates,
)
from cvnets_tpu_torch.models.classification.resnet import stochastic_depth_schedule
from cvnets_tpu_torch.modules.inverted_residual import InvertedResidualSE
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.math_utils import make_divisible

# width_mult, depth_mult, train_resolution
COMPOUND_SCALING = {
    "b0": (1.0, 1.0, 224), "b1": (1.0, 1.1, 240), "b2": (1.1, 1.2, 260),
    "b3": (1.2, 1.4, 300), "b4": (1.4, 1.8, 380), "b5": (1.6, 2.2, 456),
    "b6": (1.8, 2.6, 528), "b7": (2.0, 3.1, 600), "b8": (2.2, 3.6, 672),
}

# expand_ratio, kernel, stride, in_ch, out_ch, num_layers (Table 1, B0)
_B0_BLOCKS = [
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
]
_STAGE_ROWS = {1: [0], 2: [1], 3: [2], 4: [3, 4], 5: [5, 6]}


def get_configuration(opts) -> Dict:
    mode = (getattr(opts, "model.classification.efficientnet.mode", "b0")
            or "b0").lower()
    if mode not in COMPOUND_SCALING:
        logger.error(f"Unsupported EfficientNet mode {mode}")
    width_mult, depth_mult, _res = COMPOUND_SCALING[mode]
    rows = []
    for (exp, k, s, cin, cout, n) in _B0_BLOCKS:
        rows.append({
            "expand_ratio": exp, "kernel": k, "stride": s,
            "in_channels": int(make_divisible(cin * width_mult, 8)),
            "out_channels": int(make_divisible(cout * width_mult, 8)),
            "num_layers": int(math.ceil(n * depth_mult)),
        })
    last_channels = int(make_divisible(1280 * max(1.0, width_mult), 8))
    return {"rows": rows, "last_channels": last_channels,
            "stem_channels": rows[0]["in_channels"]}


@MODEL_REGISTRY.register(name="efficientnet", type="classification")
class EfficientNet(BaseImageEncoder):
    NEURAL_AUGMENTOR = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.efficientnet.mode", type=str,
                           default="b0")
        group.add_argument("--model.classification.efficientnet.stochastic-depth-prob",
                           type=float, default=0.2)
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        super().__init__()
        cfg = get_configuration(opts)
        sd_prob = getattr(opts, "model.classification.efficientnet.stochastic_depth_prob",
                          0.2) or 0.0
        rows = cfg["rows"]
        schedule = iter(stochastic_depth_schedule(sd_prob, sum(r["num_layers"] for r in rows)))
        in_ch = cfg["stem_channels"]
        self.conv_1 = ConvLayer2d(opts, 3, in_ch, kernel_size=3, stride=2)
        self.model_conf_dict = {"conv1": {"in": 3, "out": in_ch}}
        dilation = 1
        for li in range(1, 6):
            blocks, stage_in = [], in_ch
            for r in (rows[i] for i in _STAGE_ROWS[li]):
                for bi in range(r["num_layers"]):
                    stride = r["stride"] if bi == 0 else 1
                    if stride == 2 and dilates(output_stride, li):
                        dilation *= stride
                        stride = 1
                    blocks.append(InvertedResidualSE(
                        opts, in_ch, r["out_channels"], expand_ratio=r["expand_ratio"],
                        use_hs=False, use_se=True, stride=stride, kernel_size=r["kernel"],
                        dilation=dilation, squeeze_factor=4 * r["expand_ratio"],
                        stochastic_depth_prob=next(schedule), se_scale_fn_name="sigmoid",
                        act_fn_name="swish"))
                    in_ch = r["out_channels"]
            setattr(self, f"layer_{li}", nn.Sequential(*blocks))
            self.model_conf_dict[f"layer{li}"] = {"in": stage_in, "out": in_ch}
        last = cfg["last_channels"]
        self.conv_1x1_exp = ConvLayer2d(opts, in_ch, last, kernel_size=1)
        self.model_conf_dict["exp_before_cls"] = {"in": in_ch, "out": last}
        self.classifier = Classifier(opts, last, self.n_classes(opts),
                                     dropout=self.classifier_dropout(opts))
