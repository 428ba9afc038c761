"""Linear layers (counterpart of cvnets_tpu/layers/linear_layer.py)."""

from __future__ import annotations

import torch.nn as nn


class LinearLayer(nn.Linear):
    """``nn.Linear`` that records which initializer flag sets its weight.

    The JAX package gives a Dense ``conv_init`` where the reference used a 1×1
    conv (the separable-attention projections) and ``linear_init`` elsewhere;
    ``init_utils.init_weights`` reads ``weight_init`` to do the same."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_init: str = "linear") -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.weight_init = weight_init
