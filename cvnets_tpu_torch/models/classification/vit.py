"""Vision Transformer (counterpart of cvnets_tpu/models/classification/vit.py).

Conv stem (strides 4, 2, 2 = patch 16; BN and the activation on the first two
convs) → tokens → positional embedding at 196 positions, resampled to the token
count → CLS token first → positional dropout → pre-norm transformer blocks →
final norm → CLS embedding (or the token mean under ``no_cls_token``) → linear
classifier. The stem runs NCHW; from its output on, tokens are (B, S, E), the
JAX layout. Attributes carry the flax scope names (``patch_emb_0``,
``transformer_{i}``, ``post_transformer_norm``, ...), so
``utils.jax_params.load_jax_params`` fills the model from a flax tree.

Stochastic depth grows linearly over the blocks to ``stochastic_dropout``, as
in JAX. ``extract_features`` returns the classifier's input (the CLS
embedding after ``post_transformer_norm``, or the token mean): CLIP's image
features. ``forward(x, return_image_embeddings=True)`` also returns the
tokens after the CLS one as a (B, E, h, w) map, which
``extract_end_points_all`` gives as ``out_l5`` (vit.py:182-215), without
running the classifier. Under ``--model.classification.vit.use-simple-fpn``
(ViTDet's simple FPN, vit.py:187-206) the stride-16 map fans out instead to
``out_l2`` (two 2×2 transposed convs, the first with norm and activation,
E/4 channels), ``out_l3`` (one, E/2), ``out_l4`` (the map) and ``out_l5``
(2×2 max pool): the taps Mask R-CNN reads, whose widths ``model_conf_dict``
gives.

As a segmentation encoder (``output_stride`` 8 or 16) the stem's strides are
JAX's: (4, 2, 2) at 16, (2, 2, 2) at 8, each conv's kernel its stride
(vit.py:82-85), and the positional table is resampled to the finer grid.

Under ``--model.classification.vit.moe-num-experts`` E > 0 every
``moe-layer-period``-th block (the 2nd, 4th, ...) is a
``modules.moe.MoETransformerEncoder`` (top-``moe-top-k`` routing at
``moe-capacity-factor``), whose load-balance loss the train step adds.
Under ``--model.classification.gradient-checkpointing`` (with
``checkpoint-segments`` ≥ 1, the only way JAX reads it) each block, dense or
MoE, runs under ``layers.remat`` in training (vit.py:132-136). Not ported:
layer-wise LR decay.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d, TransposeConvLayer2d
from cvnets_tpu_torch.layers.normalization import get_normalization_layer
from cvnets_tpu_torch.layers.positional_embedding import PositionalEmbedding
from cvnets_tpu_torch.layers.remat import remat
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import BaseImageEncoder
from cvnets_tpu_torch.models.classification.config.vit import get_configuration
from cvnets_tpu_torch.modules.moe import MoETransformerEncoder
from cvnets_tpu_torch.modules.transformer import TransformerEncoder
from cvnets_tpu_torch.quantization import quant_linear


@MODEL_REGISTRY.register(name="vit", type="classification")
class VisionTransformer(BaseImageEncoder):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.vit.mode", type=str, default="base")
        group.add_argument("--model.classification.vit.dropout", type=float, default=0.0)
        group.add_argument("--model.classification.vit.stochastic-dropout",
                           type=float, default=0.0)
        group.add_argument("--model.classification.vit.norm-layer", type=str,
                           default="layer_norm")
        group.add_argument("--model.classification.vit.sinusoidal-pos-emb",
                           action="store_true", default=False)
        group.add_argument("--model.classification.vit.no-cls-token",
                           action="store_true", default=False)
        group.add_argument("--model.classification.vit.use-pytorch-mha",
                           action="store_true", default=False,
                           help="Config-compat; one MHA path")
        group.add_argument("--model.classification.vit.use-simple-fpn",
                           action="store_true", default=False)
        group.add_argument("--model.classification.vit.checkpoint-segments",
                           type=int, default=4)
        group.add_argument("--model.classification.vit.moe-num-experts", type=int,
                           default=0, help="0: dense FFN; E > 0: every "
                           "moe-layer-period-th block's FFN is an E-expert MoE")
        group.add_argument("--model.classification.vit.moe-top-k", type=int, default=2)
        group.add_argument("--model.classification.vit.moe-capacity-factor",
                           type=float, default=1.25)
        group.add_argument("--model.classification.vit.moe-layer-period", type=int,
                           default=2)
        return parser

    def __init__(self, opts, output_stride: Optional[int] = None) -> None:
        super().__init__()
        cfg = get_configuration(opts)
        embed_dim = cfg["embed_dim"]
        n_layers = cfg["n_transformer_layers"]
        sd_prob = getattr(opts, "model.classification.vit.stochastic_dropout", 0.0) or 0.0
        self.use_cls_token = not getattr(opts, "model.classification.vit.no_cls_token", False)

        stem_dim = max(32, embed_dim // 4)
        first = 2 if output_stride == 8 else 4
        self.patch_emb_0 = ConvLayer2d(opts, 3, stem_dim, kernel_size=first, stride=first)
        self.patch_emb_1 = ConvLayer2d(opts, stem_dim, stem_dim, kernel_size=2, stride=2)
        self.patch_emb_2 = ConvLayer2d(opts, stem_dim, embed_dim, kernel_size=2, stride=2,
                                       bias=True, use_norm=False, use_act=False)
        self.pos_embed = PositionalEmbedding(
            (224 // 16) ** 2, embed_dim,
            is_learnable=not getattr(opts, "model.classification.vit.sinusoidal_pos_emb",
                                     False))
        if self.use_cls_token:
            self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_emb_drop = nn.Dropout(cfg["pos_emb_drop_p"])
        self.n_layers = n_layers
        prefix = "model.classification.vit."
        n_experts = getattr(opts, prefix + "moe_num_experts", 0) or 0
        period = max(getattr(opts, prefix + "moe_layer_period", 2) or 2, 1)
        # JAX reads checkpoint-segments only as "on when >= 1"
        self.remat_blocks = bool(getattr(opts, prefix + "checkpoint_segments", 4))
        for i in range(n_layers):
            if n_experts > 0 and (i + 1) % period == 0:
                block = MoETransformerEncoder(
                    opts, embed_dim, cfg["ffn_dim"], num_heads=cfg["n_attn_heads"],
                    num_experts=n_experts,
                    top_k=getattr(opts, prefix + "moe_top_k", 2) or 2,
                    capacity_factor=getattr(opts, prefix + "moe_capacity_factor", 1.25)
                    or 1.25, attn_dropout=cfg["attn_dropout"], dropout=cfg["dropout"],
                    transformer_norm_layer=cfg["norm_layer"], norm_eps=1e-6)
            else:
                block = TransformerEncoder(
                    opts, embed_dim, cfg["ffn_dim"], num_heads=cfg["n_attn_heads"],
                    attn_dropout=cfg["attn_dropout"], dropout=cfg["dropout"],
                    ffn_dropout=cfg["ffn_dropout"], transformer_norm_layer=cfg["norm_layer"],
                    stochastic_dropout=sd_prob * i / max(n_layers - 1, 1), norm_eps=1e-6)
            self.add_module(f"transformer_{i}", block)
        self.post_transformer_norm = get_normalization_layer(
            opts, embed_dim, cfg["norm_layer"], eps=1e-6) or nn.Identity()
        self.classifier = quant_linear(
            opts, embed_dim, getattr(opts, "model.classification.n_classes", 1000))
        self.use_simple_fpn = bool(getattr(opts, "model.classification.vit.use_simple_fpn",
                                           False))
        if self.use_simple_fpn:
            e = embed_dim
            self.simple_fpn_l2_0 = TransposeConvLayer2d(opts, e, e // 2)
            self.simple_fpn_l2_1 = TransposeConvLayer2d(opts, e // 2, e // 4, bias=True,
                                                        use_norm=False, use_act=False)
            self.simple_fpn_l3 = TransposeConvLayer2d(opts, e, e // 2, bias=True,
                                                      use_norm=False, use_act=False)
            self.model_conf_dict = {"layer2": {"out": e // 4}, "layer3": {"out": e // 2},
                                    "layer4": {"out": e}, "layer5": {"out": e}}
        else:
            self.model_conf_dict = {"layer5": {"out": embed_dim}}

    def _tokens(self, x: torch.Tensor):
        """Tokens after ``post_transformer_norm`` (CLS first when there is one)
        and the stem's (h, w)."""
        x = self.patch_emb_2(self.patch_emb_1(self.patch_emb_0(x)))
        grid = tuple(x.shape[-2:])
        tokens = self.pos_embed(x.flatten(2).transpose(1, 2))  # (B, h·w, E), row-major
        if self.use_cls_token:
            cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
            tokens = torch.cat([cls, tokens], dim=1)
        tokens = self.pos_emb_drop(tokens)
        checkpointed = self.gradient_checkpointing and self.remat_blocks and self.training
        for i in range(self.n_layers):
            block = getattr(self, f"transformer_{i}")
            tokens = remat(block, tokens) if checkpointed else block(tokens)
        return self.post_transformer_norm(tokens), grid

    def _embedding(self, tokens: torch.Tensor) -> torch.Tensor:
        return tokens[:, 0] if self.use_cls_token else tokens.mean(dim=1)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, E): the classifier's input."""
        return self._embedding(self._tokens(x)[0])

    def _image_embedding(self, tokens: torch.Tensor, grid) -> torch.Tensor:
        """The tokens after the CLS one as a contiguous (B, E, h, w) map. The
        transposed view would have channels-last strides, which send cuDNN's
        dilated 3×3 convs (DeepLabv3's ASPP) to a direct kernel 7-20× slower
        than the NCHW one."""
        emb = tokens[:, 1:] if self.use_cls_token else tokens
        return emb.transpose(1, 2).reshape(emb.shape[0], -1, *grid).contiguous()

    def _taps(self, emb: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not self.use_simple_fpn:
            return {"out_l5": emb}
        return {"out_l2": self.simple_fpn_l2_1(self.simple_fpn_l2_0(emb)),
                "out_l3": self.simple_fpn_l3(emb), "out_l4": emb,
                "out_l5": F.max_pool2d(emb, 2, 2)}

    def forward(self, x: torch.Tensor, return_image_embeddings: bool = False):
        tokens, grid = self._tokens(x)
        logits = self.classifier(self._embedding(tokens))
        if not return_image_embeddings:
            return logits
        emb = self._image_embedding(tokens, grid)
        return logits, (self._taps(emb) if self.use_simple_fpn else emb)

    def extract_end_points_all(self, x: torch.Tensor, use_l5: bool = True,
                               use_l5_exp: bool = False) -> Dict[str, torch.Tensor]:
        """``{"out_l5": (B, E, h, w)}``, the token map, or the simple FPN's four
        taps, whatever the flags."""
        return self._taps(self._image_embedding(*self._tokens(x)))
