"""The port's ``layer_norm`` and ``layer_norm_2d`` (``get_normalization_layer``)
against the JAX package's on the same weights and inputs: under bf16 autocast
they return bfloat16, as the JAX norms return ``compute_dtype(opts)`` under
mixed precision (cvnets_tpu/layers/normalization.py:185-193); without autocast
they return the input's dtype; the values agree with JAX's within bf16
rounding. Swin's own LayerNorms, which its JAX norms mirror without a dtype,
stay float32 under the same autocast."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import pytest
import torch

MIXED = ["--common.mixed-precision", "--common.mixed-precision-dtype", "bfloat16"]
NORMS = ["layer_norm", "layer_norm_2d"]


def _pair(norm: str, mixed: bool, channels: int = 24):
    """The JAX norm and the port's, with the same (perturbed) scale and bias."""
    from cvnets_tpu.layers.normalization import get_normalization_layer as jax_norm
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.layers.normalization import get_normalization_layer
    from cvnets_tpu_torch.options.opts import get_training_arguments

    args = MIXED if mixed else []
    rng = np.random.default_rng(len(norm))
    scale = (1 + 0.2 * rng.standard_normal(channels)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(channels)).astype(np.float32)
    layer = get_normalization_layer(get_training_arguments(args=args), channels, norm)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(scale))
        layer.bias.copy_(torch.from_numpy(bias))
    jlayer = jax_norm(jax_args(args=args), channels, norm)
    return jlayer, {"params": {"scale": scale, "bias": bias}}, layer


def _x(dtype):
    # channels-last (B, H, W, C), as ViT's tokens and MobileViTv2's patches
    x = np.random.default_rng(3).standard_normal((2, 5, 7, 24)).astype(np.float32) * 3 + 1
    return x if dtype == "f32" else np.asarray(torch.from_numpy(x).bfloat16().float())


@pytest.mark.parametrize("in_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("norm", NORMS)
def test_norms_return_bf16_under_autocast_and_match_jax(norm, in_dtype):
    """JAX computes the statistics and the affine in float32 and casts the
    result to bfloat16; the port does the same under autocast. Both round a
    float32 value that differs only in summation order (~1e-7 relative), so
    they agree to one bf16 unit in the last place, at most 2^-7 of the value
    (8 significant bits)."""
    import jax.numpy as jnp

    jlayer, variables, layer = _pair(norm, mixed=True)
    x = _x(in_dtype)
    jx = jnp.asarray(x, jnp.float32 if in_dtype == "f32" else jnp.bfloat16)
    ref = jlayer.apply(variables, jx)
    assert ref.dtype == jnp.bfloat16
    tx = torch.from_numpy(x) if in_dtype == "f32" else torch.from_numpy(x).bfloat16()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = layer(tx)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("norm", NORMS)
def test_norms_without_autocast_return_the_input_dtype_and_match_jax(norm):
    """float32 in, float32 out, equal to the JAX norm without mixed precision
    (the same float32 math in another order: 1e-5); a bfloat16 input comes back
    in bfloat16."""
    import jax.numpy as jnp

    jlayer, variables, layer = _pair(norm, mixed=False)
    x = _x("f32")
    out = layer(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jlayer.apply(variables, jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    assert layer(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_swin_norms_stay_float32_under_autocast():
    """A micro Swin block's norm1 (a plain nn.LayerNorm) returns float32 under
    the same autocast: Swin's JAX norms carry no dtype. (Its blocks hand it
    float32; CUDA's autocast also runs layer_norm in float32 on a bf16 input,
    the CPU's does not.)"""
    sys.path.insert(0, "tests")
    from torch_port_helpers import SWIN_MICRO_ARGS

    from cvnets_tpu_torch.modules.swin_transformer_block import SwinTransformerBlock
    from cvnets_tpu_torch.options.opts import get_training_arguments

    block = SwinTransformerBlock(get_training_arguments(args=SWIN_MICRO_ARGS + MIXED), 24, 3)
    x = torch.from_numpy(_x("f32"))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert block.norm1(x).dtype == torch.float32


def test_the_norm_layers_keep_their_parameter_names():
    """``layer_norm`` is still an ``nn.LayerNorm`` (weight, bias): the JAX
    weight loader and the initialisers find it as before."""
    from cvnets_tpu_torch.layers.normalization import LayerNorm2d, get_normalization_layer

    ln = get_normalization_layer(argparse.Namespace(), 8, "layer_norm")
    ln2d = get_normalization_layer(argparse.Namespace(), 8, "layer_norm_2d")
    assert isinstance(ln, torch.nn.LayerNorm) and isinstance(ln2d, LayerNorm2d)
    assert [n for n, _ in ln.named_parameters()] == ["weight", "bias"]
    assert [n for n, _ in ln2d.named_parameters()] == ["weight", "bias"]
