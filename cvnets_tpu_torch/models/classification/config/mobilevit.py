"""MobileViTv1 configurations ``xx_small``, ``x_small`` and ``small``: a copy of
cvnets_tpu/models/classification/config/mobilevit.py, which cannot be imported
without flax (importing it runs cvnets_tpu/models/__init__.py)."""

from typing import Dict

from cvnets_tpu_torch.utils import logger

# (mv2_exp, [layer1..layer5 rows]); mobilevit rows:
# (out, transformer_channels, ffn_dim, blocks)
_MODES = {
    "xx_small": (2, [16, 24, (48, 64, 128, 2), (64, 80, 160, 4), (80, 96, 192, 3)]),
    "x_small": (4, [32, 48, (64, 96, 192, 2), (80, 120, 240, 4), (96, 144, 288, 3)]),
    "small": (4, [32, 64, (96, 144, 288, 2), (128, 192, 384, 4), (160, 240, 480, 3)]),
}
_MV2_BLOCKS = {"layer1": 1, "layer2": 3}


def get_configuration(opts) -> Dict:
    mode = (getattr(opts, "model.classification.mit.mode", "small") or "small").lower()
    if mode not in _MODES:
        logger.error(f"Unsupported MobileViT mode {mode}; choose from {sorted(_MODES)}")
    head_dim = getattr(opts, "model.classification.mit.head_dim", None)
    num_heads = getattr(opts, "model.classification.mit.number_heads", 4)
    mv2_exp, rows = _MODES[mode]

    cfg: Dict = {}
    for i, row in enumerate(rows, start=1):
        name = f"layer{i}"
        if isinstance(row, int):
            cfg[name] = {
                "out_channels": row, "expand_ratio": mv2_exp,
                "num_blocks": _MV2_BLOCKS.get(name, 1),
                "stride": 1 if name == "layer1" else 2, "block_type": "mv2",
            }
        else:
            out, tr_ch, ffn, n_blocks = row
            cfg[name] = {
                "out_channels": out, "transformer_channels": tr_ch,
                "ffn_dim": ffn, "transformer_blocks": n_blocks,
                "patch_h": 2, "patch_w": 2, "stride": 2,
                "mv_expand_ratio": mv2_exp, "head_dim": head_dim,
                "num_heads": num_heads, "block_type": "mobilevit",
            }
    cfg["last_layer_exp_factor"] = 4
    return cfg
