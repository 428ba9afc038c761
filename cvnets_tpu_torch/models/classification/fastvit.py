"""FastViT T8 … MA36 (counterpart of cvnets_tpu/models/classification/fastvit.py;
arXiv:2303.14189): a stem of three MobileOne blocks, no layer_1 (an identity),
four stages (layer_2 .. layer_5) of RepMixer blocks, or in the SA/MA variants'
last stage a RepCPE and attention blocks, each stage after the first led by a
``PatchEmbed``, then one grouped MobileOne block with SE that doubles the
width (``conv_1x1_exp``) and the classifier.

``--model.classification.fastvit.inference-mode`` builds the folded form of
every reparameterizable block, as the JAX package does.
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
from cvnets_tpu_torch.modules.fastvit import (
    AttentionBlock,
    PatchEmbed,
    RepCPE,
    RepMixerBlock,
)
from cvnets_tpu_torch.modules.mobileone_block import MobileOneBlock
from cvnets_tpu_torch.utils import logger

# layers, embed_dims, mlp_ratio, token mixer of the last stage, use_cpe
_VARIANTS = {
    "T8": ([2, 2, 4, 2], [48, 96, 192, 384], 3, "repmixer", False),
    "T12": ([2, 2, 6, 2], [64, 128, 256, 512], 3, "repmixer", False),
    "S12": ([2, 2, 6, 2], [64, 128, 256, 512], 4, "repmixer", False),
    "SA12": ([2, 2, 6, 2], [64, 128, 256, 512], 4, "attention", True),
    "SA24": ([4, 4, 12, 4], [64, 128, 256, 512], 4, "attention", True),
    "SA36": ([6, 6, 18, 6], [64, 128, 256, 512], 4, "attention", True),
    "MA36": ([6, 6, 18, 6], [76, 152, 304, 608], 4, "attention", True),
}


def get_configuration(opts) -> Dict:
    variant = getattr(opts, "model.classification.fastvit.variant", "T8") or "T8"
    if variant not in _VARIANTS:
        logger.error(f"Unsupported FastViT variant {variant}")
    layers, dims, mlp, last_mixer, use_cpe = _VARIANTS[variant]
    return {
        "layers": layers, "embed_dims": dims, "mlp_ratios": [mlp] * 4,
        "token_mixers": ["repmixer"] * 3 + [last_mixer], "use_cpe": use_cpe,
        "down_patch_size": 7, "down_stride": 2, "cls_ratio": 2.0,
        "repmixer_kernel_size": 3,
    }


@MODEL_REGISTRY.register(name="fastvit", type="classification")
class FastViT(BaseImageEncoder):
    NEURAL_AUGMENTOR = True

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        prefix = "--model.classification.fastvit."
        group.add_argument(prefix + "drop-path", type=float, default=0.0)
        group.add_argument(prefix + "use-layer-scale", action="store_true", default=True)
        group.add_argument(prefix + "layer-scale-init-value", type=float, default=1e-5)
        group.add_argument(prefix + "variant", type=str, default="T8")
        group.add_argument(prefix + "dropout", type=float, default=0.0)
        group.add_argument(prefix + "stochastic-depth-prob", type=float, default=0.0)
        group.add_argument(prefix + "inference-mode", action="store_true", default=False)
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        super().__init__()
        cfg = get_configuration(opts)
        prefix = "model.classification.fastvit."
        inference = getattr(opts, prefix + "inference_mode", False)
        # the JAX model reads drop_path first, stochastic_depth_prob if it is None
        sd_prob = getattr(opts, prefix + "drop_path", None)
        if sd_prob is None:
            sd_prob = getattr(opts, prefix + "stochastic_depth_prob", 0.0)
        sd_prob = sd_prob or 0.0
        dropout = getattr(opts, prefix + "dropout", 0.0) or 0.0
        use_ls = getattr(opts, prefix + "use_layer_scale", True)
        ls_init = getattr(opts, prefix + "layer_scale_init_value", 1e-5)
        dims, layers = cfg["embed_dims"], cfg["layers"]
        total = sum(layers)

        self.conv_1 = nn.Sequential(
            MobileOneBlock(opts, 3, dims[0], 3, stride=2, num_conv_branches=1,
                           inference_mode=inference),
            MobileOneBlock(opts, dims[0], dims[0], 3, stride=2, groups=dims[0],
                           num_conv_branches=1, inference_mode=inference),
            MobileOneBlock(opts, dims[0], dims[0], 1, num_conv_branches=1,
                           inference_mode=inference))
        self.layer_1 = nn.Identity()
        self.model_conf_dict = {"conv1": {"in": 3, "out": dims[0]},
                                "layer1": {"in": dims[0], "out": dims[0]}}
        bid = 0
        for si in range(4):
            blocks = []
            if si > 0:
                blocks.append(PatchEmbed(opts, dims[si - 1], dims[si],
                                         patch_size=cfg["down_patch_size"],
                                         stride=cfg["down_stride"], inference_mode=inference))
            attention = cfg["token_mixers"][si] == "attention"
            if attention and cfg["use_cpe"]:
                blocks.append(RepCPE(opts, dims[si], inference_mode=inference))
            for _ in range(layers[si]):
                p = sd_prob * bid / max(total - 1, 1)
                if attention:
                    blocks.append(AttentionBlock(
                        opts, dims[si], mlp_ratio=cfg["mlp_ratios"][si],
                        num_heads=max(1, dims[si] // 32), dropout=dropout,
                        stochastic_depth_prob=p, use_layer_scale=use_ls,
                        layer_scale_init_value=ls_init))
                else:
                    blocks.append(RepMixerBlock(
                        opts, dims[si], kernel_size=cfg["repmixer_kernel_size"],
                        mlp_ratio=cfg["mlp_ratios"][si], dropout=dropout,
                        stochastic_depth_prob=p, use_layer_scale=use_ls,
                        layer_scale_init_value=ls_init, inference_mode=inference))
                bid += 1
            setattr(self, f"layer_{si + 2}", nn.Sequential(*blocks))
            self.model_conf_dict[f"layer{si + 2}"] = {"in": dims[max(0, si - 1)],
                                                      "out": dims[si]}
        exp_ch = int(dims[-1] * cfg["cls_ratio"])
        self.conv_1x1_exp = nn.Sequential(MobileOneBlock(
            opts, dims[-1], exp_ch, 3, groups=dims[-1], use_se=True, num_conv_branches=1,
            inference_mode=inference))
        self.model_conf_dict["exp_before_cls"] = {"in": dims[-1], "out": exp_ch}
        self.classifier = Classifier(opts, exp_ch, self.n_classes(opts),
                                     dropout=self.classifier_dropout(opts))
