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
``extract_end_points_all`` gives as ``out_l5`` (vit.py:182-215, without the
simple FPN). Not ported yet, and raising if asked for: MoE blocks and the
simple FPN; not ported and without a flag here: gradient checkpointing and
layer-wise LR decay.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.layers.normalization import get_normalization_layer
from cvnets_tpu_torch.layers.positional_embedding import PositionalEmbedding
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.base_image_encoder import BaseImageEncoder
from cvnets_tpu_torch.models.classification.config.vit import get_configuration
from cvnets_tpu_torch.modules.transformer import TransformerEncoder

# options of the JAX model that the port does not have yet
_UNPORTED = {
    "model.classification.vit.moe_num_experts": "MoE transformer blocks",
    "model.classification.vit.use_simple_fpn": "the simple FPN",
}


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
                           default=0, help="Not ported: must be 0 (dense FFN)")
        group.add_argument("--model.classification.vit.moe-top-k", type=int, default=2)
        group.add_argument("--model.classification.vit.moe-capacity-factor",
                           type=float, default=1.25)
        group.add_argument("--model.classification.vit.moe-layer-period", type=int,
                           default=2)
        return parser

    def __init__(self, opts) -> None:
        super().__init__()
        for flag, what in _UNPORTED.items():
            if getattr(opts, flag, None):
                raise NotImplementedError(f"ViT: {what} (--{flag}) is not ported")
        cfg = get_configuration(opts)
        embed_dim = cfg["embed_dim"]
        n_layers = cfg["n_transformer_layers"]
        sd_prob = getattr(opts, "model.classification.vit.stochastic_dropout", 0.0) or 0.0
        self.use_cls_token = not getattr(opts, "model.classification.vit.no_cls_token", False)

        stem_dim = max(32, embed_dim // 4)
        self.patch_emb_0 = ConvLayer2d(opts, 3, stem_dim, kernel_size=4, stride=4)
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
        for i in range(n_layers):
            self.add_module(f"transformer_{i}", TransformerEncoder(
                opts, embed_dim, cfg["ffn_dim"], num_heads=cfg["n_attn_heads"],
                attn_dropout=cfg["attn_dropout"], dropout=cfg["dropout"],
                ffn_dropout=cfg["ffn_dropout"], transformer_norm_layer=cfg["norm_layer"],
                stochastic_dropout=sd_prob * i / max(n_layers - 1, 1), norm_eps=1e-6))
        self.post_transformer_norm = get_normalization_layer(
            opts, embed_dim, cfg["norm_layer"], eps=1e-6) or nn.Identity()
        self.classifier = LinearLayer(
            embed_dim, getattr(opts, "model.classification.n_classes", 1000))

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
        for i in range(self.n_layers):
            tokens = getattr(self, f"transformer_{i}")(tokens)
        return self.post_transformer_norm(tokens), grid

    def _embedding(self, tokens: torch.Tensor) -> torch.Tensor:
        return tokens[:, 0] if self.use_cls_token else tokens.mean(dim=1)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, E): the classifier's input."""
        return self._embedding(self._tokens(x)[0])

    def forward(self, x: torch.Tensor, return_image_embeddings: bool = False):
        tokens, (h, w) = self._tokens(x)
        logits = self.classifier(self._embedding(tokens))
        if not return_image_embeddings:
            return logits
        grid = tokens[:, 1:] if self.use_cls_token else tokens
        return logits, grid.transpose(1, 2).reshape(grid.shape[0], -1, h, w)

    def extract_end_points_all(self, x: torch.Tensor, use_l5: bool = True,
                               use_l5_exp: bool = False) -> Dict[str, torch.Tensor]:
        """``{"out_l5": (B, E, h, w)}``, the token map, whatever the flags."""
        return {"out_l5": self(x, return_image_embeddings=True)[1]}
