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
head's) and ``logit_scale`` and the MoE FFN's stacked ``experts_fc{1,2}`` and
``experts_fc{1,2}_bias`` keep their names (and their (E, ·, ·) layout: the
router's ``kernel`` is an ordinary Dense), and so do the neural
augmentor's scalars (``neural_augmentor/{brightness,contrast,noise}_{mag,min,max}``).
``load_jax_teacher`` fills a distillation loss's teacher from the JAX loss's
``teacher_variables``.
The segmentation heads' scopes (PSPNet's ``psp/psp_branch_<i>`` and
``psp/fusion``, the separable ASPP's ``aspp/aspp_sep_<i>/{dw_conv,pw_conv}``,
the simple head's ``conv``) and Mask R-CNN's (``fpn/lateral_{i}``,
``rpn_head/cls_logits``, ``box_head/fc``, ``mask_head/deconv``, the ViT's
``simple_fpn_l2_0/conv``, ...) follow the same rule. Only leaves named ``kernel``
change layout, by rank: a conv HWIO → OIHW (a
depthwise (kh, kw, 1, O) becomes (O, 1, kh, kw)), a 1-D conv (k, in, out) →
(out, in, k) (ByteFormer's ``token_reduction``) and a Dense (in, out) → Linear
(out, in). Every other leaf, a 2-D positional or byte-embedding table
included, keeps its layout. ByteFormer's scopes (``token_embedding``,
``pos_embed/pos_embed``, ``transformer_{i}/block/...``,
``downsample_{i}/{reduction,norm}``) follow the same rule.
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
         "logit_scale": "logit_scale",
         **{f"experts_fc{i}{b}": f"experts_fc{i}{b}" for i in (1, 2) for b in ("", "_bias")},
         **{f"{aug}_{part}": f"{aug}_{part}" for aug in ("brightness", "contrast", "noise")
            for part in ("mag", "min", "max")}}
# a list of modules in flax (``layer_3_0``, FastViT's ``conv_1_0`` and
# ``conv_1x1_exp_0``, SSD's ``extra_layers_0`` and ``ssd_heads_0``, Mask
# R-CNN's ``proj_layers_0``) is an ``nn.Sequential`` or ``nn.ModuleList``
# entry here (``layer_3.0``)
_STAGE = re.compile(r"^(layer_\d+|conv_1|conv_1x1_exp|extra_layers|ssd_heads|proj_layers)_(\d+)$")


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
    if value.ndim == 3:  # 1-D conv (k, in, out) -> (out, in, k)
        return value.transpose(2, 1, 0)
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


def load_jax_teacher(criteria, teacher_variables: Mapping) -> None:
    """Fill the teacher of a distillation loss (or of every distillation entry
    of a composite loss) from a JAX distillation loss's ``teacher_variables``
    (its params and batch stats)."""
    losses = getattr(criteria, "loss_fns", {"": criteria}).values()
    teachers = [fn.teacher for fn in losses if hasattr(fn, "teacher")]
    if not teachers:
        raise ValueError(f"{criteria!r} has no teacher")
    for teacher in teachers:
        load_jax_params(teacher, teacher_variables["params"],
                        teacher_variables.get("batch_stats"))
