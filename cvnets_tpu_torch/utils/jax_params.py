"""Fill a port model from a flax variable tree (numpy leaves).

Port module attributes are named after the flax scopes, so a flax path maps to a
``state_dict`` key by rule: ``/`` becomes ``.``, a list stage ``layer_3_0`` is the
``nn.Sequential`` entry ``layer_3.0`` (FastViT's ``conv_1_0`` and
``conv_1x1_exp_0`` and SSD's ``extra_layers_0`` and ``ssd_heads_0`` too), and
the leaf names change as
``kernel``/``scale`` → ``weight`` and ``mean``/``var`` → ``running_mean``/
``running_var``; ViT's ``pos_embed`` table and top-level ``cls_token`` and
Swin's ``relative_position_bias_table``, PReLU's ``alpha``, FastViT's
``layer_scale``, ``layer_scale_1`` and ``layer_scale_2``, and CLIP's
``token_embedding``, ``projection`` (the text tower's), ``proj`` (the image
head's) and ``logit_scale`` keep their names.
The segmentation heads' scopes (PSPNet's ``psp/psp_branch_<i>`` and
``psp/fusion``, the separable ASPP's ``aspp/aspp_sep_<i>/{dw_conv,pw_conv}``,
the simple head's ``conv``) follow the same rule. Only leaves named ``kernel``
change layout, by rank: a conv HWIO → OIHW (a
depthwise (kh, kw, 1, O) becomes (O, 1, kh, kw)) and a Dense (in, out) → Linear
(out, in). Every other leaf, a 2-D positional table included, keeps its layout.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var",
         "pos_embed": "pos_embed", "cls_token": "cls_token",
         "relative_position_bias_table": "relative_position_bias_table",
         "alpha": "alpha", "layer_scale": "layer_scale",
         "layer_scale_1": "layer_scale_1", "layer_scale_2": "layer_scale_2",
         "token_embedding": "token_embedding", "projection": "projection", "proj": "proj",
         "logit_scale": "logit_scale"}
# a list of modules in flax (``layer_3_0``, FastViT's ``conv_1_0`` and
# ``conv_1x1_exp_0``, SSD's ``extra_layers_0`` and ``ssd_heads_0``) is an
# ``nn.Sequential`` or ``nn.ModuleList`` entry here (``layer_3.0``)
_STAGE = re.compile(r"^(layer_\d+|conv_1|conv_1x1_exp|extra_layers|ssd_heads)_(\d+)$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def torch_key(flax_path: Tuple[str, ...]) -> str:
    *scopes, leaf = flax_path
    parts = []
    for s in scopes:
        m = _STAGE.match(s)
        parts.extend(m.groups() if m else (s,))
    if leaf not in _LEAF:
        raise KeyError(f"no torch name for flax leaf {'/'.join(flax_path)}")
    return ".".join(parts + [_LEAF[leaf]])


def to_torch_layout(flax_path: Tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """A flax leaf in the layout of its torch tensor."""
    if flax_path[-1] != "kernel":
        return value
    if value.ndim == 4:  # conv HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return value.T
    return value


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> None:
    """Copy every flax leaf into ``model``. Raises unless each flax leaf is used
    exactly once and every parameter and buffer of ``model`` is filled (BN's
    ``num_batches_tracked`` counter has no flax leaf and is left as it is)."""
    targets: Dict[str, torch.Tensor] = {
        k: v for k, v in model.state_dict().items()
        if not k.endswith("num_batches_tracked")}
    filled = set()
    for tree in (params, batch_stats or {}):
        for path, value in _flatten(tree):
            key = torch_key(path)
            if key not in targets:
                raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: no such "
                               "parameter or buffer in the model")
            if key in filled:
                raise KeyError(f"two flax leaves map to {key}")
            value = to_torch_layout(path, value)
            dst = targets[key]
            if tuple(value.shape) != tuple(dst.shape):
                raise ValueError(f"{'/'.join(path)}: shape {value.shape} vs "
                                 f"{key} {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(value)))  # a writable copy
            filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"{len(missing)} model tensors have no flax leaf: {missing[:8]}")
