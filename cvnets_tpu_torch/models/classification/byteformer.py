"""ByteFormer (counterpart of cvnets_tpu/models/classification/byteformer.py):
classification of file bytes.

Tokens (B, N) of byte values, ``padding_index`` (and any negative value)
marking padding → the byte embedding ``token_embedding`` (vocab × E; padding
takes the last id, the mask token) → the token-reduction ``Conv1d`` (kernel k,
stride max(1, k/2), no padding, no bias; a reduced token is padding only if
its whole receptive field was) → the positional table sliced to the length
(``pos_embed``, learnable at std 0.02 or sinusoidal) and its dropout → the
``WindowedTransformerEncoder`` layers ``transformer_{i}`` (windows and shifts
per layer: shift 0 on even layers and w/2 on odd ones by default; stochastic
depth sd·i/(n−1)), each followed, where ``downsample`` says so (after layers
3, 7, 11 by default), by ``downsample_{i}``, the token merging that also
merges the mask → ``post_transformer_norm`` → the mean over the tokens that
are not padding → ``classifier``.

The widths come from ViT's modes (tiny: E 192, 12 layers, 3 heads). Padding
tokens are not masked in attention unless
``--model.classification.byteformer.mask-windowed-attn`` is set (see
``modules/windowed_transformer.py``); they are zeroed at token merging and
left out of the pool. Attribute names are the flax scopes, so
``utils.jax_params.load_jax_params`` fills the model from a flax tree.

``AudioByteFormer`` is the same model registered under
``audio_classification``, with that category's name and pretrained flags.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.init_utils import init_tensor
from cvnets_tpu_torch.layers.positional_embedding import PositionalEmbedding
from cvnets_tpu_torch.layers.token_merging import TokenMerging
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.classification.config.vit import _MODES as _VIT_MODES
from cvnets_tpu_torch.modules.windowed_transformer import WindowedTransformerEncoder
from cvnets_tpu_torch.quantization import quant_linear

_PREFIX = "model.classification.byteformer."


def get_configuration(opts) -> Dict:
    """byteformer.py:28-41: ViT's widths for the mode (tiny for an unknown one)."""
    mode = (getattr(opts, _PREFIX + "mode", "tiny") or "tiny").lower()
    embed_dim, n_layers, n_heads, pos_drop = _VIT_MODES.get(mode, _VIT_MODES["tiny"])
    return {"embed_dim": embed_dim, "n_transformer_layers": n_layers,
            "n_attn_heads": n_heads, "ffn_dim": embed_dim * 4,
            "norm_layer": getattr(opts, _PREFIX + "norm_layer", "layer_norm"),
            "pos_emb_drop_p": pos_drop, "attn_dropout": 0.0, "ffn_dropout": 0.0,
            "dropout": getattr(opts, _PREFIX + "dropout", 0.0)}


class ByteFormerTokenMerging(TokenMerging):
    """Token merging of a window of 2 that also merges the padding mask
    (byteformer.py:44-77): masked tokens zeroed first; a merged token is
    padding only if all its constituents were."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        x = super().forward(x.masked_fill(mask[..., None], 0.0))
        mask = F.pad(mask, (0, (-mask.shape[1]) % self.window), value=True)
        return x, mask.reshape(mask.shape[0], -1, self.window).all(dim=-1)


@MODEL_REGISTRY.register(name="byteformer", type="classification")
class ByteFormer(nn.Module):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls.__name__ != "ByteFormer":
            return parser  # AudioByteFormer shares these flags
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.classification.byteformer.dropout", type=float,
                           default=0.0)
        group.add_argument("--model.classification.byteformer.stochastic-dropout",
                           type=float, default=0.0)
        group.add_argument("--model.classification.byteformer.norm-layer", type=str,
                           default="layer_norm")
        group.add_argument("--model.classification.byteformer.sinusoidal-pos-emb",
                           action="store_true", default=False)
        group.add_argument("--model.classification.byteformer.use-pytorch-mha",
                           action="store_true", default=False,
                           help="Config-compat; one MHA path")
        group.add_argument("--model.classification.byteformer.mode", type=str,
                           default="tiny")
        group.add_argument("--model.classification.byteformer.vocab-size", type=int,
                           default=257)
        group.add_argument("--model.classification.byteformer.max-num-tokens",
                           type=int, default=50000)
        group.add_argument("--model.classification.byteformer.conv-kernel-size",
                           type=int, default=16)
        group.add_argument("--model.classification.byteformer.window-sizes",
                           type=int, nargs="+", default=[128])
        group.add_argument("--model.classification.byteformer.window-shifts",
                           type=int, nargs="+", default=None)
        group.add_argument("--model.classification.byteformer.downsample",
                           type=str, nargs="+", default=None,
                           help="Per-layer true/false: merge tokens after the layer")
        group.add_argument("--model.classification.byteformer.mask-windowed-attn",
                           action="store_true", default=False,
                           help="Mask padded tokens and the shifted windows' "
                                "wrap-around in attention (the reference computes "
                                "these masks and never applies them)")
        group.add_argument("--model.classification.byteformer.padding-index",
                           type=int, default=-1)
        group.add_argument(
            "--model.classification.byteformer.dummy-input-token-length",
            type=int, default=1024)
        return parser

    @classmethod
    def build_model(cls, opts, **kwargs) -> "ByteFormer":
        return cls(opts, **kwargs)

    @staticmethod
    def get_lr_multipliers(opts) -> Dict[str, float]:
        return {}

    def __init__(self, opts) -> None:
        super().__init__()
        cfg = get_configuration(opts)
        embed_dim, n_layers = cfg["embed_dim"], cfg["n_transformer_layers"]
        self.embed_dim, self.n_layers = embed_dim, n_layers
        self.vocab_size = getattr(opts, _PREFIX + "vocab_size", 257)
        pad_idx = getattr(opts, _PREFIX + "padding_index", -1)
        self.padding_index = -1 if pad_idx is None else pad_idx
        window_sizes = list(getattr(opts, _PREFIX + "window_sizes", [128]) or [128])
        if len(window_sizes) == 1:
            window_sizes = window_sizes * n_layers
        window_shifts = getattr(opts, _PREFIX + "window_shifts", None) or [
            0 if i % 2 == 0 else window_sizes[i] // 2 for i in range(n_layers)]
        downsample = getattr(opts, _PREFIX + "downsample", None)
        downsample = ([i % 4 == 3 for i in range(n_layers)] if downsample is None
                      else [str(d).lower() in ("true", "1") for d in downsample])
        sd_prob = getattr(opts, _PREFIX + "stochastic_dropout", 0.0) or 0.0

        self.token_embedding = nn.Parameter(torch.empty(self.vocab_size, embed_dim))
        conv_k = getattr(opts, _PREFIX + "conv_kernel_size", 16)
        self.conv_kernel, self.conv_stride = conv_k, max(1, (conv_k or 0) // 2)
        self.token_reduction = (nn.Conv1d(embed_dim, embed_dim, conv_k, self.conv_stride,
                                          bias=False) if conv_k and conv_k > 0 else None)
        self.pos_embed = PositionalEmbedding(
            getattr(opts, _PREFIX + "max_num_tokens", 50000), embed_dim,
            is_learnable=not getattr(opts, _PREFIX + "sinusoidal_pos_emb", False),
            resize_mode="slice")
        self.pos_emb_drop = nn.Dropout(cfg["pos_emb_drop_p"])
        self.downsample_after = downsample
        for i in range(n_layers):
            self.add_module(f"transformer_{i}", WindowedTransformerEncoder(
                opts, embed_dim, cfg["ffn_dim"], num_heads=cfg["n_attn_heads"],
                attn_dropout=cfg["attn_dropout"], dropout=cfg["dropout"],
                ffn_dropout=cfg["ffn_dropout"], window_size=window_sizes[i],
                window_shift=window_shifts[i], transformer_norm_layer=cfg["norm_layer"],
                stochastic_dropout=sd_prob * i / max(n_layers - 1, 1)))
            if downsample[i]:
                self.add_module(f"downsample_{i}", ByteFormerTokenMerging(embed_dim))
        self.post_transformer_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.classifier = quant_linear(
            opts, embed_dim, getattr(opts, "model.classification.n_classes", 1000))

    def init_own_parameters(self, generator) -> None:
        """flax's initializers of the table (a normal truncated at two standard
        deviations of sqrt(1/E)) and of the reduction conv (``lecun_normal``, its
        default)."""
        init_tensor(self.token_embedding, "trunc_normal", self.embed_dim ** -0.5, generator)
        if self.token_reduction is not None:
            init_tensor(self.token_reduction.weight, "lecun_normal", None, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: (B, N) integer tokens; returns (B, n_classes) logits."""
        mask = (x == self.padding_index) | (x < 0)
        ids = torch.where(mask, self.vocab_size - 1, x).long()
        h = F.embedding(ids, self.token_embedding)
        if self.token_reduction is not None:
            h = self.token_reduction(h.transpose(1, 2)).transpose(1, 2)
            # a reduced token is padding only if its whole receptive field was
            mask = mask.unfold(1, self.conv_kernel, self.conv_stride).all(dim=-1)
        h = self.pos_emb_drop(self.pos_embed(h))
        for i in range(self.n_layers):
            h = getattr(self, f"transformer_{i}")(h, key_padding_mask=mask)
            if self.downsample_after[i]:
                h, mask = getattr(self, f"downsample_{i}")(h, mask)
        h = self.post_transformer_norm(h)
        keep = (~mask).to(h.dtype)[..., None]
        pooled = (h * keep).sum(dim=1) / keep.sum(dim=1).clamp(min=1.0)
        return self.classifier(pooled)


@MODEL_REGISTRY.register(name="byteformer", type="audio_classification")
class AudioByteFormer(ByteFormer):
    """ByteFormer over audio file bytes (byteformer.py:236-251)."""

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--model.audio-classification.name", type=str, default=None)
        group.add_argument("--model.audio-classification.pretrained", type=str,
                           default=None)
        return parser
