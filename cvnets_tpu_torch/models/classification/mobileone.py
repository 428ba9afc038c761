"""MobileOne s0-s4 (counterpart of cvnets_tpu/models/classification/mobileone.py;
arXiv:2206.04040): a MobileOne stem block, no layer_1 (an identity), four
stages of depthwise + pointwise ``MobileOneBlock`` pairs (layer_2 ..
layer_5), SE in the last blocks of s4, and the classifier.

``--model.classification.mobileone.inference-mode`` builds every block in its
folded form (one conv with a bias), which loads the JAX package's
``get_exportable_params``; ``utils.reparam_utils.reparameterize_model`` folds
a trained model in place into the same form.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch.nn as nn

from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import (
    BaseImageEncoder,
    Classifier,
)
from cvnets_tpu_torch.modules.mobileone_block import MobileOneBlock
from cvnets_tpu_torch.utils import logger

# blocks a stage, width multipliers a stage, conv branches, SE
_VARIANTS = {
    "s0": ([2, 8, 10, 1], (0.75, 1.0, 1.0, 2.0), 4, False),
    "s1": ([2, 8, 10, 1], (1.5, 1.5, 2.0, 2.5), 1, False),
    "s2": ([2, 8, 10, 1], (1.5, 2.0, 2.5, 4.0), 1, False),
    "s3": ([2, 8, 10, 1], (2.0, 2.5, 3.0, 4.0), 1, False),
    "s4": ([2, 8, 10, 1], (3.0, 3.5, 3.5, 4.0), 1, True),
}


def get_configuration(opts) -> Dict:
    variant = getattr(opts, "model.classification.mobileone.variant", "s1") or "s1"
    if variant not in _VARIANTS:
        logger.error(f"Unsupported MobileOne variant {variant}")
    blocks, widths, branches, use_se = _VARIANTS[variant]
    return {"num_blocks_per_stage": blocks, "width_multipliers": widths,
            "num_conv_branches": branches, "use_se": use_se}


@MODEL_REGISTRY.register(name="mobileone", type="classification")
class MobileOne(BaseImageEncoder):
    NEURAL_AUGMENTOR = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.mobileone.variant", type=str,
                           default="s1")
        group.add_argument("--model.classification.mobileone.inference-mode",
                           action="store_true", default=False,
                           help="Build the reparameterized (merged-branch) model")
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        super().__init__()
        cfg = get_configuration(opts)
        inference = getattr(opts, "model.classification.mobileone.inference_mode", False)
        widths, nblocks = cfg["width_multipliers"], cfg["num_blocks_per_stage"]
        n_branches, use_se = cfg["num_conv_branches"], cfg["use_se"]
        in_ch = min(64, int(64 * widths[0]))
        self.conv_1 = MobileOneBlock(opts, 3, in_ch, kernel_size=3, stride=2,
                                     num_conv_branches=1, inference_mode=inference)
        self.layer_1 = nn.Identity()
        self.model_conf_dict = {"conv1": {"in": 3, "out": in_ch},
                                "layer1": {"in": in_ch, "out": in_ch}}
        stage_planes = [int(64 * widths[0]), int(128 * widths[1]),
                        int(256 * widths[2]), int(512 * widths[3])]
        stage_se = [0, 0, nblocks[2] // 2 if use_se else 0, nblocks[3] if use_se else 0]
        for si in range(4):
            planes, n, n_se = stage_planes[si], nblocks[si], stage_se[si]
            blocks, stage_in = [], in_ch
            for bi in range(n):
                se = bi >= n - n_se
                blocks.append(MobileOneBlock(  # depthwise
                    opts, in_ch, in_ch, kernel_size=3, stride=2 if bi == 0 else 1,
                    groups=in_ch, use_se=se, num_conv_branches=n_branches,
                    inference_mode=inference))
                blocks.append(MobileOneBlock(  # pointwise
                    opts, in_ch, planes, kernel_size=1, use_se=se,
                    num_conv_branches=n_branches, inference_mode=inference))
                in_ch = planes
            setattr(self, f"layer_{si + 2}", nn.Sequential(*blocks))
            self.model_conf_dict[f"layer{si + 2}"] = {"in": stage_in, "out": in_ch}
        self.model_conf_dict["exp_before_cls"] = {"in": in_ch, "out": in_ch}
        self.classifier = Classifier(opts, in_ch, self.n_classes(opts),
                                     dropout=self.classifier_dropout(opts))
