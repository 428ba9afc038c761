"""The layout rule of each parameter over the (data, model) grid (counterpart of
cvnets_tpu/parallel/sharding_rules.py:40-103).

JAX gives each parameter leaf a partition spec and lets GSPMD place it; the
port reads the same rule, leaf for leaf, and keeps the same elements on each
rank:

* tensor parallelism (a ``model`` axis larger than 1): a Dense kernel shards
  its output features (column-parallel), or its input features when its path
  holds a row-parallel token (``out_proj``, ``ffn_fc2``, ``red_1x1``,
  ``conv_proj``); a conv kernel its output channels, or its input channels
  under a row token; a 1-D ``bias`` or ``scale`` of at least 8·M elements off
  a row path shards with the output it follows; an ``experts_*`` stack
  (modules/moe.py) shards its leading expert dim. A dim the axis does not
  divide stays whole.
* FSDP (``--dev.fsdp``): a leaf of at least ``FSDP_MIN_SIZE`` elements shards
  its largest still-free dim that the data axis divides (ties toward the
  trailing dim) over ``data``; smaller leaves stay whole.

"Trailing" and "input/output" are JAX's layout: a Dense kernel is (in, out)
in JAX and (out, in) here, a conv kernel HWIO there and OIHW here, a 1-D
conv (k, in, out) there and (out, in, k) here (``utils/jax_params.
to_torch_layout``). The rule runs on the JAX view of each tensor and maps
its dims back, so that a port leaf shards the same elements as its JAX leaf.
The port's names follow the flax scopes (``weight`` of rank ≥ 2 is a
``kernel``, of rank 1 a ``scale``), so the tokens match as they are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch.nn as nn

from cvnets_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

ROW_PARALLEL_TOKENS = ("out_proj", "ffn_fc2", "red_1x1", "conv_proj")
FSDP_MIN_SIZE = 8192
# torch dim i of a kernel is JAX dim _PERM[rank][i] (to_torch_layout's transposes)
_PERM = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


@dataclass(frozen=True)
class LeafSpec:
    """The torch dims of a parameter that the model and the data axes shard
    (None: that axis keeps it whole)."""
    model_dim: Optional[int] = None
    data_dim: Optional[int] = None

    @property
    def sharded(self) -> bool:
        return self.model_dim is not None or self.data_dim is not None


def jax_view(name: str, shape: Sequence[int]) -> Tuple[str, Tuple[int, ...], Tuple[int, ...]]:
    """(JAX leaf name, JAX shape, perm) of a port parameter: torch dim i is
    JAX dim perm[i]."""
    leaf = name.rsplit(".", 1)[-1]
    ndim = len(shape)
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    perm = _PERM.get(ndim, tuple(range(ndim))) if leaf == "kernel" else tuple(range(ndim))
    jshape = [0] * ndim
    for i, j in enumerate(perm):
        jshape[j] = int(shape[i])
    return leaf, tuple(jshape), perm


def _tp_spec(name: str, leaf: str, shape: Tuple[int, ...], tp: int) -> List[Optional[str]]:
    """sharding_rules.py:56-88 ``_tp_spec`` on the JAX view."""
    spec: List[Optional[str]] = [None] * len(shape)
    if tp <= 1:
        return spec
    row = any(tok in name for tok in ROW_PARALLEL_TOKENS)
    if leaf.startswith("experts_"):
        if shape[0] % tp == 0:
            spec[0] = MODEL_AXIS
        return spec
    if leaf == "kernel" and len(shape) == 2:
        if row and shape[0] % tp == 0:
            spec[0] = MODEL_AXIS
        elif not row and shape[1] % tp == 0:
            spec[1] = MODEL_AXIS
    elif leaf == "kernel" and len(shape) == 4:
        if row and shape[2] % tp == 0:
            spec[2] = MODEL_AXIS
        elif not row and shape[3] % tp == 0:
            spec[3] = MODEL_AXIS
    elif leaf in ("bias", "scale") and len(shape) == 1:
        if not row and shape[0] % tp == 0 and shape[0] >= tp * 8:
            spec[0] = MODEL_AXIS
    return spec


def _add_fsdp_axis(spec: List[Optional[str]], shape: Tuple[int, ...], dp: int) -> None:
    """sharding_rules.py:91-103 ``_add_fsdp_axis`` on the JAX view."""
    size = 1
    for s in shape:
        size *= s
    if dp <= 1 or size < FSDP_MIN_SIZE:
        return
    cand = [d for d in range(len(shape)) if spec[d] is None and shape[d] % dp == 0
            and shape[d] > 1]
    if cand:
        spec[max(cand, key=lambda d: (shape[d], d))] = DATA_AXIS


def leaf_spec(name: str, shape: Sequence[int], data: int, model: int,
              fsdp: bool) -> LeafSpec:
    """The spec of one port parameter over a (data, model) grid."""
    if len(shape) == 0:
        return LeafSpec()
    leaf, jshape, perm = jax_view(name, shape)
    spec = _tp_spec(name, leaf, jshape, model)
    if fsdp:
        _add_fsdp_axis(spec, jshape, data)
    torch_spec = [spec[perm[i]] for i in range(len(shape))]
    dims = {axis: (torch_spec.index(axis) if axis in torch_spec else None)
            for axis in (MODEL_AXIS, DATA_AXIS)}
    return LeafSpec(dims[MODEL_AXIS], dims[DATA_AXIS])


def infer_param_specs(model: nn.Module, data: int, model_size: int,
                      fsdp: bool = False) -> Dict[str, LeafSpec]:
    """Each parameter's spec by name (``infer_param_sharding``): the model
    axis's rules when ``model_size`` > 1, the data axis's under ``fsdp``."""
    return {name: leaf_spec(name, tuple(p.shape), data, model_size, fsdp)
            for name, p in model.named_parameters()}
