"""MobileViTv2 configuration: a copy of
cvnets_tpu/models/classification/config/mobilevit_v2.py, which cannot be imported
without flax (importing it runs cvnets_tpu/models/__init__.py)."""

from typing import Dict

from cvnets_tpu_torch.utils.math_utils import bound_fn, make_divisible


def get_configuration(opts) -> Dict:
    width_multiplier = getattr(opts, "model.classification.mitv2.width_multiplier", 1.0)

    ffn_multiplier = 2
    mv2_exp_mult = 2

    layer_0_dim = bound_fn(min_val=16, max_val=64, value=32 * width_multiplier)
    layer_0_dim = int(make_divisible(layer_0_dim, divisor=8, min_value=16))

    def ch(base, divisor=8):
        return int(make_divisible(base * width_multiplier, divisor=divisor))

    return {
        "layer0": {"img_channels": 3, "out_channels": layer_0_dim},
        "layer1": {"out_channels": ch(64, 16), "expand_ratio": mv2_exp_mult,
                   "num_blocks": 1, "stride": 1, "block_type": "mv2"},
        "layer2": {"out_channels": ch(128), "expand_ratio": mv2_exp_mult,
                   "num_blocks": 2, "stride": 2, "block_type": "mv2"},
        "layer3": {"out_channels": ch(256), "attn_unit_dim": ch(128),
                   "ffn_multiplier": ffn_multiplier, "attn_blocks": 2,
                   "patch_h": 2, "patch_w": 2, "stride": 2,
                   "mv_expand_ratio": mv2_exp_mult, "block_type": "mobilevit"},
        "layer4": {"out_channels": ch(384), "attn_unit_dim": ch(192),
                   "ffn_multiplier": ffn_multiplier, "attn_blocks": 4,
                   "patch_h": 2, "patch_w": 2, "stride": 2,
                   "mv_expand_ratio": mv2_exp_mult, "block_type": "mobilevit"},
        "layer5": {"out_channels": ch(512), "attn_unit_dim": ch(256),
                   "ffn_multiplier": ffn_multiplier, "attn_blocks": 3,
                   "patch_h": 2, "patch_w": 2, "stride": 2,
                   "mv_expand_ratio": mv2_exp_mult, "block_type": "mobilevit"},
        "last_layer_exp_factor": 4,
    }
