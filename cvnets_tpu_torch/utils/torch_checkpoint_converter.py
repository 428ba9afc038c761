"""Reference CVNets checkpoint → port state dict (counterpart of
cvnets_tpu/utils/torch_checkpoint_converter.py).

A published CVNets checkpoint is a torch ``state_dict`` whose tensors are named
after the reference's modules, which the port's names are not. The walk is
the JAX package's: structural and order-preserving. Both sides enumerate
modules in definition order, so the k-th reference conv weight is the k-th
port conv weight:

* the reference's tensors are split by role: parameters (without BN's
  ``num_batches_tracked`` and Swin's ``relative_position_index`` and
  ``attn_mask``, which the port computes), ``running_mean`` and
  ``running_var``;
* a pre-pass pairs distinctive tensors by name (``pos_embed``, ``cls_token``,
  Swin's bias tables and merges' ``reduction``, SE units, CLIP's text
  projection, ByteFormer's downsamplers), which the two sides may register at
  different places;
* a two-pointer walk over the port's parameters takes, for each, the first
  reference tensor within 8 ahead whose role agrees and whose shape converts;
  what it skips or leaves over is reported, and a port tensor with no match
  keeps its value;
* the running statistics pair by position.

Both sides are torch layouts, so a tensor moves as it is, except where the
port's layout is not the reference's (``utils/jax_params.to_torch_layout``
composed with the JAX converter's transform): a reference 1×1 conv lands on a
port linear weight (the separable attention's projections) with its 1×1
dims dropped, and a positional or embedding table may be transposed or
squeezed. ``--model.rename-scopes-map`` rewrites the reference's keys first
and ``--model.resume-exclude-scopes`` drops those that match.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cvnets_tpu_torch.utils import logger

_SKIPPED = ("running_mean", "running_var", "num_batches_tracked", "relative_position_index",
            "attn_mask")
# (port substring, reference substring): a token naming as many tensors on each
# side, paired in order before the walk (the JAX package's DISTINCTIVE)
DISTINCTIVE = (
    ("pos_embed",) * 2, ("cls_token",) * 2, ("logit_scale",) * 2,
    ("class_embedding",) * 2, ("post_transformer_norm",) * 2,
    ("relative_position_bias_table",) * 2, ("reduction",) * 2,
    (".se.", ".se."),
    ("text_encoder.projection", "text_encoder.projection_layer"),
    ("downsample_", "downsamplers.downsample_"),
)
LOOKAHEAD = 8


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a reference checkpoint on the CPU (a bare state dict, or
    one under ``model_state_dict`` or ``state_dict``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "state_dict"):
        if isinstance(blob, dict) and isinstance(blob.get(key), dict):
            blob = blob[key]
    return {k: v for k, v in blob.items() if isinstance(v, torch.Tensor)}


def _is_kernel(key: str, value: torch.Tensor) -> bool:
    """A port tensor that is a flax ``kernel`` (a conv or linear weight):
    named ``weight`` and of rank 2 or more (a norm's scale is 1-D)."""
    return key.rsplit(".", 1)[-1] == "weight" and value.dim() >= 2


def _port_role(key: str) -> str:
    leaf = key.rsplit(".", 1)[-1]
    if leaf in ("weight", "pos_embed", "proj", "cls_token", "token_embedding", "projection"):
        return "weight"
    return "bias" if leaf == "bias" else "other"


def _reference_role(key: str) -> str:
    if key.endswith("weight"):
        return "weight"
    return "bias" if key.endswith("bias") else "other"


def _convert(w: torch.Tensor, target: torch.Size, kernel: bool) -> Optional[torch.Tensor]:
    """``w`` in the port tensor's layout, or None where it cannot be."""
    if kernel:
        if w.dim() == 4 and len(target) == 2 and w.shape[2:] == (1, 1):
            w = w[:, :, 0, 0]  # a reference 1×1 conv where the port has a linear
        return w if w.shape == target else None
    if w.shape == target:
        return w
    if w.dim() == 2 and w.t().shape == target:  # a table stored transposed
        return w.t()
    squeeze = lambda shape: tuple(s for s in shape if s != 1)  # noqa: E731
    if squeeze(w.shape) == squeeze(target) and w.numel() == target.numel():
        return w.reshape(target)  # e.g. a layer scale (C, 1, 1) onto (C,)
    return None


def convert_checkpoint(state_dict: Dict[str, torch.Tensor], current: Dict[str, torch.Tensor],
                       rename_map: Sequence[Tuple[str, str]] = (),
                       exclude_scopes: str = "") -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """``current`` (the port model's state dict) with the reference
    ``state_dict``'s tensors walked onto it; returns it and the unmatched
    report (``port:`` tensors left at their value, ``reference:`` tensors
    skipped or left over, statistics out of step)."""
    for pat, rep in rename_map:
        state_dict = {re.sub(pat, rep, k): v for k, v in state_dict.items()}
    excluded = [p.strip() for p in exclude_scopes.split(",") if p.strip()]
    if excluded:
        state_dict = {k: v for k, v in state_dict.items()
                      if not any(re.match(p, k) for p in excluded)}
    ref_params = [(k, v) for k, v in state_dict.items() if not k.endswith(_SKIPPED)]
    ref_stats = {stat: [(k, v) for k, v in state_dict.items() if k.endswith(stat)]
                 for stat in ("running_mean", "running_var")}
    targets = [(k, v) for k, v in current.items() if not k.endswith(_SKIPPED)]
    out = dict(current)
    unmatched: List[str] = []

    def put(key: str, value: torch.Tensor) -> None:
        out[key] = value.to(current[key].dtype).clone()

    paired_port, paired_ref = set(), set()
    for port_token, ref_token in DISTINCTIVE:
        port_hits = [i for i, (k, _) in enumerate(targets) if port_token in k]
        ref_hits = [i for i, (k, _) in enumerate(ref_params) if ref_token in k]
        if not port_hits or len(port_hits) != len(ref_hits):
            continue
        for pi, ri in zip(port_hits, ref_hits):
            key, fresh = targets[pi]
            w = ref_params[ri][1]
            value = _convert(w, fresh.shape, _is_kernel(key, fresh))
            if value is None and w.numel() == fresh.numel():
                value = w.reshape(fresh.shape)
            if value is not None:
                put(key, value)
                paired_port.add(pi)
                paired_ref.add(ri)
    targets = [t for i, t in enumerate(targets) if i not in paired_port]
    ref_params = [r for i, r in enumerate(ref_params) if i not in paired_ref]

    ptr, skipped = 0, []
    for key, fresh in targets:
        role, kernel = _port_role(key), _is_kernel(key, fresh)
        found = None
        for idx in range(ptr, min(ptr + LOOKAHEAD, len(ref_params))):
            ref_key, w = ref_params[idx]
            ref_role = _reference_role(ref_key)
            if role != "other" and ref_role != "other" and role != ref_role:
                continue
            value = _convert(w, fresh.shape, kernel)
            if value is not None:
                found = idx
                break
        if found is None:
            unmatched.append(f"port:{key} shape={tuple(fresh.shape)} (desync at reference#{ptr})")
            continue
        skipped.extend(k for k, _ in ref_params[ptr:found])
        put(key, value)
        ptr = found + 1
    unmatched.extend(f"reference:{k} (skipped)" for k in skipped)
    unmatched.extend(f"reference:{k} (trailing)" for k, _ in ref_params[ptr:])

    for stat, ref_side in ref_stats.items():
        port_side = [k for k in current if k.endswith(stat)]
        for i, key in enumerate(port_side):
            if i >= len(ref_side):
                unmatched.append(f"batch_stats missing reference {stat} for {key}")
            elif ref_side[i][1].shape != current[key].shape:
                unmatched.append(f"batch_stats desync: port:{key} {tuple(current[key].shape)} "
                                 f"vs reference:{ref_side[i][0]} {tuple(ref_side[i][1].shape)}")
            else:
                put(key, ref_side[i][1])
    return out, unmatched


def load_reference_checkpoint(path: str, current: Dict[str, torch.Tensor],
                              rename_map: Sequence[Tuple[str, str]] = (),
                              exclude_scopes: str = "") -> Dict[str, torch.Tensor]:
    """``convert_checkpoint`` of the file at ``path``; the unmatched tensors
    are logged as a warning."""
    out, unmatched = convert_checkpoint(load_torch_state_dict(path), current,
                                        rename_map=rename_map, exclude_scopes=exclude_scopes)
    if unmatched:
        logger.warning(f"{len(unmatched)} parameters not matched from {path}; first few: "
                       f"{unmatched[:5]}")
    return out
