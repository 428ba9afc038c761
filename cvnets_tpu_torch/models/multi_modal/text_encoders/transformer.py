"""CLIP's text transformer (counterpart of
cvnets_tpu/models/multi_modal/text_encoders/transformer.py).

Token table lookup (the pad id's row zeroed when ``--dataset.padding-index``
is set; no embedding scale, as in the JAX package, whatever
``no-scale-embedding`` says) → learnable positional embedding, resampled to
the sequence length as the JAX one is when the collate cuts the context
(``trunc-seq-len``) → embedding dropout → pre-norm ``TransformerEncoder``
blocks, under ``causal-masking`` with the additive mask ``triu(finfo(float32).min, 1)``,
which sends their attention down the einsum route → ``final_norm``
(LayerNorm, eps 1e-5) → the features at the EOT token (the largest id of each
row, its first place) → the ``projection`` matrix.

A (B, n_captions, L) input (zero-shot class captions) is folded into the
batch, and the projected features are mean-pooled over the captions and
L2-normalized. Parameter names are the flax ones (``token_embedding``,
``pos_embed``, ``transformer_{i}``, ``final_norm``, ``projection``), so
``utils.jax_params.load_jax_params`` fills the encoder from a flax tree.
Under ``--model.text.transformer.gradient-checkpoint`` each block runs under
``layers.remat`` in training (transformer.py:145-147: one block a segment,
whatever ``num-checkpoint-segments`` says).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.init_utils import init_tensor
from cvnets_tpu_torch.layers.positional_embedding import PositionalEmbedding
from cvnets_tpu_torch.layers.remat import remat
from cvnets_tpu_torch.models.multi_modal.text_encoders import TEXT_ENCODER_REGISTRY
from cvnets_tpu_torch.modules.transformer import TransformerEncoder


def _per_layer(values, n_layers: int) -> list:
    values = [values] if isinstance(values, (int, float)) else list(values)
    return (values * n_layers)[:n_layers]


@TEXT_ENCODER_REGISTRY.register(name="transformer")
class TextTransformer(nn.Module):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.text.context-length", type=int, default=77)
        group.add_argument("--model.text.vocab-size", type=int, default=49408)
        group.add_argument("--model.text.transformer.model-dim", type=int, default=512)
        group.add_argument("--model.text.transformer.no-scale-embedding", action="store_true")
        group.add_argument("--model.text.transformer.no-pos-embedding", action="store_true")
        group.add_argument("--model.text.transformer.embed-dropout", type=float, default=0.0)
        group.add_argument("--model.text.transformer.n-transformer-layers", type=int,
                           default=12)
        group.add_argument("--model.text.transformer.n-heads-per-layer", type=int, nargs="+",
                           default=[8])
        group.add_argument("--model.text.transformer.ffn-multiplier-per-layer", type=float,
                           nargs="+", default=[4.0])
        group.add_argument("--model.text.transformer.attn-dropout", type=float, default=0.0)
        group.add_argument("--model.text.transformer.ffn-dropout", type=float, default=0.0)
        group.add_argument("--model.text.transformer.dropout", type=float, default=0.0)
        group.add_argument("--model.text.transformer.norm-layer", type=str,
                           default="layer_norm")
        group.add_argument("--model.text.transformer.sinusoidal-pos-emb", action="store_true")
        group.add_argument("--model.text.transformer.gradient-checkpoint", action="store_true",
                           help="Recompute each block in the backward")
        group.add_argument("--model.text.transformer.num-checkpoint-segments", type=int,
                           default=1)
        group.add_argument("--model.text.transformer.causal-masking", action="store_true",
                           default=False)
        group.add_argument("--model.text.transformer.classes-per-split-zero-shot", type=int,
                           default=20)
        return parser

    def __init__(self, opts, projection_dim: int = 256) -> None:
        super().__init__()
        prefix = "model.text.transformer."
        self.gradient_checkpoint = bool(getattr(opts, prefix + "gradient_checkpoint", False))
        dim = getattr(opts, prefix + "model_dim", 512)
        n_layers = getattr(opts, prefix + "n_transformer_layers", 12)
        heads = _per_layer(getattr(opts, prefix + "n_heads_per_layer", [8]), n_layers)
        ffn = _per_layer(getattr(opts, prefix + "ffn_multiplier_per_layer", [4.0]), n_layers)
        self.model_dim, self.n_layers = dim, n_layers
        self.causal = getattr(opts, prefix + "causal_masking", False)
        self.pad_idx = getattr(opts, "dataset.padding_index", None)
        self.token_embedding = nn.Parameter(
            torch.empty(getattr(opts, "model.text.vocab_size", 49408), dim))
        self.pos_embed = None
        if not getattr(opts, prefix + "no_pos_embedding", False):
            self.pos_embed = PositionalEmbedding(
                getattr(opts, "model.text.context_length", 77), dim,
                is_learnable=not getattr(opts, prefix + "sinusoidal_pos_emb", False))
        self.embed_dropout = nn.Dropout(getattr(opts, prefix + "embed_dropout", 0.0) or 0.0)
        for i in range(n_layers):
            self.add_module(f"transformer_{i}", TransformerEncoder(
                opts, dim, int(ffn[i] * dim), num_heads=heads[i],
                attn_dropout=getattr(opts, prefix + "attn_dropout", 0.0) or 0.0,
                dropout=getattr(opts, prefix + "dropout", 0.0) or 0.0,
                ffn_dropout=getattr(opts, prefix + "ffn_dropout", 0.0) or 0.0,
                transformer_norm_layer=getattr(opts, prefix + "norm_layer", "layer_norm")))
        self.final_norm = nn.LayerNorm(dim, eps=1e-5)
        self.projection = nn.Parameter(torch.empty(dim, projection_dim))
        self._masks: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def init_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The token table and the projection: normals at std model_dim^-0.5."""
        for p in (self.token_embedding, self.projection):
            init_tensor(p, "normal", self.model_dim ** -0.5, generator)

    def causal_mask(self, seq: int, device: torch.device) -> torch.Tensor:
        """(1, 1, seq, seq): 0 on and below the diagonal, float32's min above;
        made once a length and device, on the device (no upload)."""
        key = (seq, device)
        if key not in self._masks:
            self._masks[key] = torch.full((seq, seq), torch.finfo(torch.float32).min,
                                          device=device).triu(1)[None, None]
        return self._masks[key]

    def forward(self, text: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) int ids → (B, projection_dim); (B, n_captions, L) → the
        normalized mean over the captions."""
        fold = text.dim() == 3
        if fold:
            b, n_cap, seq = text.shape
            text = text.reshape(b * n_cap, seq)
        x = F.embedding(text, self.token_embedding)
        if self.pad_idx is not None:
            x = x.masked_fill((text == self.pad_idx)[..., None], 0.0)
        if self.pos_embed is not None:
            x = self.pos_embed(x)
        x = self.embed_dropout(x)
        attn_mask = self.causal_mask(x.shape[1], x.device) if self.causal else None
        checkpointed = self.gradient_checkpoint and self.training
        for i in range(self.n_layers):
            block = getattr(self, f"transformer_{i}")
            x = (remat(block, x, None, key_padding_mask, attn_mask) if checkpointed
                 else block(x, None, key_padding_mask, attn_mask))
        x = self.final_norm(x)
        feats = x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
        feats = feats @ self.projection
        if fold:
            feats = feats.reshape(b, n_cap, -1).mean(dim=1)
            feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        return feats
