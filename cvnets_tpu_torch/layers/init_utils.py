"""Weight initialisation (counterpart of cvnets_tpu/layers/init_utils.py).

Each name draws from the same distribution as the flax initializer the JAX package
picks for it (``kaiming_normal`` is flax ``he_normal``: a normal truncated at two
standard deviations and rescaled to variance 2/fan_in). Draws come from an explicit
``torch.Generator``. Fans follow flax: a conv's fan-in is kh·kw·in/groups and a
linear layer's is its input width, which torch's (out, in, ...) layouts give too.
Learnable positional tables, ViT's ``cls_token`` and Swin's
``relative_position_bias_table`` draw from flax ``truncated_normal``
(positional_embedding.py:66-69, vit.py:105-107, swin_transformer_block.py:90-94),
which is the ``trunc_normal`` rule here. A module with parameters of its own
that none of these rules covers (CLIP's token table, projections and
``logit_scale``) draws them in its ``init_own_parameters(generator)``. A
conv that the JAX package builds without a ``kernel_init`` (Swin's patch
embedding) takes flax's default, ``lecun_normal``: it carries
``weight_init = "lecun_normal"``. A conv or linear layer whose JAX
initializer is a fixed normal (Mask R-CNN's RPN and box predictors) carries
``weight_init = ("normal", std)``. ``BlockConvTranspose`` takes the conv rule:
its fan-in, kh·kw·in, is flax's for its (kh, kw, in, out) kernel.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import torch
import torch.nn as nn

from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.layers.conv_layer import BlockConvTranspose
from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.layers.normalization import LayerNorm2d
from cvnets_tpu_torch.layers.positional_embedding import PositionalEmbedding

SUPPORTED_INIT = ("kaiming_normal", "lecun_normal", "normal", "trunc_normal")

# stddev of a unit normal truncated to (-2, 2) (flax variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_tensor(w: torch.Tensor, name: str, std: float,
                generator: Optional[torch.Generator]) -> None:
    name = (name or "kaiming_normal").lower()
    if name in ("kaiming_normal", "lecun_normal"):
        fan_in = w[0].numel()  # in/groups · kh · kw, or a linear layer's input width
        scale = 2.0 if name == "kaiming_normal" else 1.0
        s = math.sqrt(scale / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, s, -2 * s, 2 * s, generator=generator)
    elif name == "normal":
        nn.init.normal_(w, 0.0, std, generator=generator)
    elif name == "trunc_normal":
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    else:
        logger.error(f"Unsupported initializer {name}; supported: {SUPPORTED_INIT}")


def init_weights(model: nn.Module, opts, generator: Optional[torch.Generator]) -> None:
    """Initialise every conv, linear and norm layer of ``model`` in module order.

    Convs and the ``LinearLayer``s built with ``weight_init="conv"`` take
    ``model.layer.conv_init``; other ``LinearLayer``s take
    ``model.layer.linear_init``. Biases are zero, norm scales one; positional
    tables, a module's ``cls_token`` and ``relative_position_bias_table`` are
    truncated normals at std 0.02."""
    conv = (getattr(opts, "model.layer.conv_init", "kaiming_normal"),
            getattr(opts, "model.layer.conv_init_std_dev", 0.01) or 0.01)
    linear = (getattr(opts, "model.layer.linear_init", "normal"),
              getattr(opts, "model.layer.linear_init_std_dev", 0.01) or 0.01)
    for m in model.modules():
        own = getattr(m, "weight_init", None)
        if isinstance(own, tuple):  # (name, std) of the module's own initializer
            init_tensor(m.weight, *own, generator)
        elif isinstance(m, (nn.Conv2d, BlockConvTranspose)):
            init_tensor(m.weight, *((own, None) if own else conv), generator)
        elif isinstance(m, LinearLayer):
            init_tensor(m.weight, *(conv if m.weight_init == "conv" else linear),
                        generator)
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.GroupNorm, LayerNorm2d,
                            nn.LayerNorm)):
            nn.init.ones_(m.weight)
        else:
            if isinstance(m, PositionalEmbedding) and m.pos_embed is not None:
                init_tensor(m.pos_embed, "trunc_normal", 0.02, generator)
            for name in ("cls_token", "relative_position_bias_table"):
                if isinstance(getattr(m, name, None), nn.Parameter):
                    init_tensor(getattr(m, name), "trunc_normal", 0.02, generator)
            if hasattr(m, "init_own_parameters"):
                m.init_own_parameters(generator)
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)


def arguments_weight_init(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Weight initialization arguments")
    group.add_argument("--model.layer.conv-init", type=str, default="kaiming_normal")
    group.add_argument("--model.layer.conv-init-std-dev", type=float, default=None)
    group.add_argument("--model.layer.linear-init", type=str, default="normal")
    group.add_argument("--model.layer.linear-init-std-dev", type=float, default=0.01)
    return parser
