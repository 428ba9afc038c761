"""ViT configuration: a copy of cvnets_tpu/models/classification/config/vit.py,
which cannot be imported without flax (importing it runs
cvnets_tpu/models/__init__.py)."""

from typing import Dict

from cvnets_tpu.utils import logger

# mode: (embed_dim, n_transformer_layers, n_attn_heads, pos_emb_drop_p);
# "micro" is the JAX package's small test variant
_MODES = {
    "micro": (64, 2, 4, 0.0),
    "tiny": (192, 12, 3, 0.1),
    "small": (384, 12, 6, 0.0),
    "base": (768, 12, 12, 0.0),
    "large": (1024, 24, 16, 0.0),
    "huge": (1280, 32, 20, 0.0),
}


def get_configuration(opts) -> Dict:
    mode = (getattr(opts, "model.classification.vit.mode", "tiny") or "tiny").lower()
    if mode not in _MODES:
        logger.error(f"Unsupported ViT mode {mode}; choose from {sorted(_MODES)}")
    dropout = getattr(opts, "model.classification.vit.dropout", 0.0)
    norm_layer = getattr(opts, "model.classification.vit.norm_layer", "layer_norm")
    embed_dim, n_layers, n_heads, pos_drop = _MODES[mode]
    return {
        "embed_dim": embed_dim,
        "n_transformer_layers": n_layers,
        "n_attn_heads": n_heads,
        "ffn_dim": embed_dim * 4,
        "norm_layer": norm_layer,
        "pos_emb_drop_p": pos_drop,
        "attn_dropout": 0.0,
        "ffn_dropout": 0.0,
        "dropout": dropout,
    }
