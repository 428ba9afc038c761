"""``load_jax_params`` changes the layout of ``kernel`` leaves only: a 2-D leaf
that is not a Dense kernel (ViT's positional table) lands as it is, and a
top-level parameter (ViT's ``cls_token``) has a name."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.positional_embedding import PositionalEmbedding
from cvnets_tpu_torch.utils.jax_params import load_jax_params, to_torch_layout, torch_key


class _Tiny(nn.Module):
    def __init__(self, rows: int, dim: int) -> None:
        super().__init__()
        self.pos_embed = PositionalEmbedding(rows, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.fc = nn.Linear(dim, 3)


@pytest.mark.parametrize("rows,dim", [(7, 5), (4, 4)], ids=["non_square", "square"])
def test_non_kernel_2d_leaves_keep_their_layout(rows, dim):
    rng = np.random.default_rng(0)
    tree = {"pos_embed": {"pos_embed": rng.standard_normal((rows, dim)).astype(np.float32)},
            "cls_token": rng.standard_normal((1, 1, dim)).astype(np.float32),
            "fc": {"kernel": rng.standard_normal((dim, 3)).astype(np.float32),
                   "bias": rng.standard_normal(3).astype(np.float32)}}
    model = _Tiny(rows, dim)
    load_jax_params(model, tree)
    np.testing.assert_array_equal(model.pos_embed.pos_embed.detach().numpy(),
                                  tree["pos_embed"]["pos_embed"])
    np.testing.assert_array_equal(model.cls_token.detach().numpy(), tree["cls_token"])
    np.testing.assert_array_equal(model.fc.weight.detach().numpy(), tree["fc"]["kernel"].T)


def test_keys_and_layouts():
    assert torch_key(("cls_token",)) == "cls_token"
    assert torch_key(("pos_embed", "pos_embed")) == "pos_embed.pos_embed"
    assert torch_key(("transformer_11", "mha", "qkv_proj", "kernel")) == \
        "transformer_11.mha.qkv_proj.weight"
    assert torch_key(("layer_3_1", "conv", "kernel")) == "layer_3.1.conv.weight"
    conv = np.zeros((3, 3, 4, 8))
    assert to_torch_layout(("conv", "kernel"), conv).shape == (8, 4, 3, 3)
    assert to_torch_layout(("fc", "kernel"), np.zeros((4, 8))).shape == (8, 4)
    assert to_torch_layout(("pos_embed", "pos_embed"), np.zeros((4, 8))).shape == (4, 8)
