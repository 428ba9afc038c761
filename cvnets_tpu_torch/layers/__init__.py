"""Atomic layers as ``torch.nn`` modules (counterpart of cvnets_tpu/layers)."""

import argparse

from cvnets_tpu_torch.layers.activation import arguments_activation_fn
from cvnets_tpu_torch.layers.init_utils import arguments_weight_init
from cvnets_tpu_torch.layers.normalization import arguments_norm_layers


def layer_specific_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Layer arguments")
    group.add_argument("--model.layer.global-pool", type=str, default="mean",
                       help="Global pooling type: mean, rms or abs")
    parser = arguments_weight_init(parser)
    parser = arguments_norm_layers(parser)
    parser = arguments_activation_fn(parser)
    return parser
