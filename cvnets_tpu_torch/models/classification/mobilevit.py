"""MobileViTv1 (counterpart of cvnets_tpu/models/classification/mobilevit.py):
a 3×3 stem, MV2 stages, then stages of an InvertedResidual and a
``MobileViTBlock``, a 1×1 expansion to min(4 × layer_5's width, 960) and the
classifier. Module attributes carry the flax scope names, so
``utils.jax_params.load_jax_params`` can fill the model from a flax tree."""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import (
    BaseImageEncoder,
    Classifier,
    dilates,
)
from cvnets_tpu_torch.models.classification.config.mobilevit import get_configuration
from cvnets_tpu_torch.modules.inverted_residual import InvertedResidual
from cvnets_tpu_torch.modules.mobilevit_block import MobileViTBlock


@MODEL_REGISTRY.register(name="mobilevit", type="classification")
class MobileViT(BaseImageEncoder):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        prefix = "--model.classification.mit."
        group.add_argument(prefix + "mode", type=str, default="small")
        group.add_argument(prefix + "attn-dropout", type=float, default=0.0)
        group.add_argument(prefix + "ffn-dropout", type=float, default=0.0)
        group.add_argument(prefix + "dropout", type=float, default=0.0)
        group.add_argument(prefix + "transformer-norm-layer", type=str, default="layer_norm")
        group.add_argument(prefix + "no-fuse-local-global-features", action="store_true",
                           default=False)
        group.add_argument(prefix + "conv-kernel-size", type=int, default=3)
        group.add_argument(prefix + "head-dim", type=int, default=None)
        group.add_argument(prefix + "number-heads", type=int, default=None)
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        """``output_stride`` 8 dilates layer_4 and layer_5, 16 layer_5 only: a
        dilated stage's InvertedResidual runs at stride 1 with the previous
        dilation, its MobileViTBlock at the new one."""
        super().__init__()
        cfg = get_configuration(opts)
        in_ch = 16
        self.conv_1 = ConvLayer2d(opts, 3, in_ch, kernel_size=3, stride=2)
        self.model_conf_dict = {"conv1": {"in": 3, "out": in_ch}}
        dilation = 1
        for idx in range(1, 6):
            stage_in = in_ch
            stage, in_ch, dilation = self._make_stage(
                opts, cfg[f"layer{idx}"], in_ch, dilation, dilates(output_stride, idx))
            setattr(self, f"layer_{idx}", stage)
            self.model_conf_dict[f"layer{idx}"] = {"in": stage_in, "out": in_ch}
        exp_ch = min(cfg.get("last_layer_exp_factor", 4) * in_ch, 960)
        self.conv_1x1_exp = ConvLayer2d(opts, in_ch, exp_ch, kernel_size=1)
        self.model_conf_dict["exp_before_cls"] = {"in": in_ch, "out": exp_ch}
        self.classifier = Classifier(opts, exp_ch, self.n_classes(opts),
                                     dropout=self.classifier_dropout(opts))

    @staticmethod
    def _make_stage(opts, cfg: Dict, in_ch: int, dilation: int, dilate: bool
                    ) -> Tuple[nn.Sequential, int, int]:
        blocks = []
        if cfg.get("block_type", "mobilevit") != "mobilevit":
            out_ch = cfg["out_channels"]
            for i in range(cfg.get("num_blocks", 2)):
                blocks.append(InvertedResidual(
                    opts, in_ch, out_ch, stride=cfg.get("stride", 1) if i == 0 else 1,
                    expand_ratio=cfg.get("expand_ratio", 4)))
                in_ch = out_ch
            return nn.Sequential(*blocks), in_ch, dilation

        stride, prev_dilation = cfg.get("stride", 1), dilation
        if stride == 2:
            if dilate:
                dilation, stride = dilation * 2, 1
            blocks.append(InvertedResidual(
                opts, in_ch, cfg["out_channels"], stride=stride,
                expand_ratio=cfg.get("mv_expand_ratio", 4), dilation=prev_dilation))
            in_ch = cfg["out_channels"]
        head_dim = cfg.get("head_dim")
        if head_dim is None:
            head_dim = cfg["transformer_channels"] // (cfg.get("num_heads", 4) or 4)
        prefix = "model.classification.mit."
        blocks.append(MobileViTBlock(
            opts, in_ch, cfg["transformer_channels"], cfg["ffn_dim"],
            n_transformer_blocks=cfg.get("transformer_blocks", 1), head_dim=head_dim,
            patch_h=cfg.get("patch_h", 2), patch_w=cfg.get("patch_w", 2),
            dropout=getattr(opts, prefix + "dropout", 0.0),
            ffn_dropout=getattr(opts, prefix + "ffn_dropout", 0.0),
            attn_dropout=getattr(opts, prefix + "attn_dropout", 0.0),
            conv_ksize=getattr(opts, prefix + "conv_kernel_size", 3),
            no_fusion=getattr(opts, prefix + "no_fuse_local_global_features", False),
            transformer_norm_layer=getattr(opts, prefix + "transformer_norm_layer",
                                           "layer_norm"),
            dilation=dilation))
        return nn.Sequential(*blocks), in_ch, dilation
