"""Swin Transformer (counterpart of cvnets_tpu/models/classification/swin_transformer.py).

Patch conv (4×4, stride 4, padding 1, no bias, as the JAX model pads it) run
NCHW and permuted once to NHWC → ``patch_norm`` → four stages of
``SwinTransformerBlock`` (shift 0 and ws // 2 alternating, stochastic depth
growing linearly to ``stochastic_depth_prob`` over all blocks) with a
``PatchMerging`` between stages → ``post_norm`` → mean over the map → linear
classifier. Attribute names are the flax scopes (``patch_embed``,
``stage{i}_block{j}``, ``merge{i}``, ``post_norm``, ``classifier``). Under
``--model.classification.gradient-checkpointing`` each block runs under
``layers.remat`` in training.

Under ``--common.int8-inference`` the blocks' qkv, projection and MLP layers
and the classifier take the int8 forward (``quantization.quant_linear``, the
JAX ``quant_dense``). Any norm layer but ``layer_norm`` is an error, as in JAX.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.remat import remat
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import BaseImageEncoder
from cvnets_tpu_torch.modules.swin_transformer_block import PatchMerging, SwinTransformerBlock
from cvnets_tpu_torch.quantization import quant_linear
from cvnets_tpu_torch.utils import logger

# embed_dim, depths, num_heads
_MODES = {
    "tiny": (96, [2, 2, 6, 2], [3, 6, 12, 24]),
    "small": (96, [2, 2, 18, 2], [3, 6, 12, 24]),
    "base": (128, [2, 2, 18, 2], [4, 8, 16, 32]),
    "large": (192, [2, 2, 18, 2], [6, 12, 24, 48]),
}


def get_configuration(opts) -> Dict:
    mode = (getattr(opts, "model.classification.swin.mode", "tiny") or "tiny").lower()
    if mode not in _MODES:
        logger.error(f"Unsupported Swin mode {mode}; choose from {sorted(_MODES)}")
    embed_dim, depths, heads = _MODES[mode]
    return {
        "embed_dim": embed_dim, "depths": depths, "num_heads": heads,
        "window_size": getattr(opts, "model.classification.swin.window_size", 7),
        "mlp_ratio": 4.0,
        "dropout": getattr(opts, "model.classification.swin.dropout", 0.0),
        "attn_dropout": getattr(opts, "model.classification.swin.attn_dropout", 0.0),
        "stochastic_depth_prob": getattr(
            opts, "model.classification.swin.stochastic_depth_prob", 0.2),
        "patch_size": 4,
    }


@MODEL_REGISTRY.register(name="swin", type="classification")
class SwinTransformer(BaseImageEncoder):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.swin.mode", type=str, default="tiny")
        group.add_argument("--model.classification.swin.extract-end-point-format",
                           type=str, default="nhwc", choices=["nchw", "nhwc"],
                           help="Config-compat; end points are NHWC either way")
        group.add_argument("--model.classification.swin.window-size", type=int, default=7)
        group.add_argument("--model.classification.swin.dropout", type=float, default=0.0)
        group.add_argument("--model.classification.swin.attn-dropout", type=float,
                           default=0.0)
        group.add_argument("--model.classification.swin.stochastic-depth-prob",
                           type=float, default=0.2)
        group.add_argument("--model.classification.swin.norm-layer", type=str,
                           default="layer_norm")
        return parser

    def __init__(self, opts) -> None:
        super().__init__()
        norm_name = getattr(opts, "model.classification.swin.norm_layer", "layer_norm")
        if norm_name not in (None, "layer_norm"):
            logger.error(f"swin: only layer_norm is supported, got {norm_name}")
        cfg = get_configuration(opts)
        ps, dim = cfg["patch_size"], cfg["embed_dim"]
        # bias-free patchify conv with the reference's (k - 1) // 2 = 1 padding
        self.patch_embed = nn.Conv2d(3, dim, ps, stride=ps, padding=(ps - 1) // 2, bias=False)
        self.patch_embed.weight_init = "lecun_normal"  # flax nn.Conv's default
        self.patch_norm = nn.LayerNorm(dim, eps=1e-5)
        self.depths = cfg["depths"]
        total, bid = sum(self.depths), 0
        for si, (depth, heads) in enumerate(zip(self.depths, cfg["num_heads"])):
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", SwinTransformerBlock(
                    opts, dim, heads, window_size=cfg["window_size"],
                    shift_size=0 if bi % 2 == 0 else cfg["window_size"] // 2,
                    mlp_ratio=cfg["mlp_ratio"], dropout=cfg["dropout"],
                    attn_dropout=cfg["attn_dropout"],
                    stochastic_depth_prob=cfg["stochastic_depth_prob"] * bid
                    / max(total - 1, 1)))
                bid += 1
            if si < len(self.depths) - 1:
                self.add_module(f"merge{si}", PatchMerging(opts, dim))
                dim *= 2
        self.post_norm = nn.LayerNorm(dim, eps=1e-5)
        self.classifier = quant_linear(opts, dim, getattr(opts, "model.classification.n_classes",
                                                   1000))

    def _forward_stages(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))  # NHWC from here on
        out = {"out_l1": x}
        checkpointed = self.gradient_checkpointing and self.training  # swin :116-117
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                block = getattr(self, f"stage{si}_block{bi}")
                x = remat(block, x) if checkpointed else block(x)
            out[f"out_l{si + 2}"] = x
            if si < len(self.depths) - 1:
                x = getattr(self, f"merge{si}")(x)
        return out

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C): the classifier's input (CLIP's image features; the JAX
        CLIP's stage loop would pass the image through, as for the ViT)."""
        return self.post_norm(self._forward_stages(x)["out_l5"]).mean(dim=(1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.extract_features(x))

    def extract_end_points_all(self, x: torch.Tensor, use_l5: bool = True,
                               use_l5_exp: bool = False) -> Dict[str, torch.Tensor]:
        """NHWC features after the patch norm (``out_l1``) and after each stage
        (``out_l2``..``out_l5``), as the JAX model returns them whatever the
        flags."""
        return self._forward_stages(x)
