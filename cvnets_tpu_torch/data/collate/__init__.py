"""Collate-function registry (counterpart of cvnets_tpu/data/collate/__init__.py)."""

from __future__ import annotations

from cvnets_tpu_torch.utils.registry import Registry

COLLATE_FN_REGISTRY = Registry(registry_name="torch_collate_fn")


def build_collate_fn(opts, mode: str = "train"):
    name = getattr(opts, f"dataset.collate_fn_name_{mode}", None) or "default_collate_fn"
    return COLLATE_FN_REGISTRY[name]


# registers the ported collate functions (after COLLATE_FN_REGISTRY exists)
from cvnets_tpu_torch.data.collate import (  # noqa: E402,F401
    byteformer_collate_functions,
    collate_functions,
)
