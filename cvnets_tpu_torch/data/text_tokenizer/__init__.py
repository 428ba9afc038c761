"""Tokenizer registry (counterpart of cvnets_tpu/data/text_tokenizer/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.utils.registry import Registry

TOKENIZER_REGISTRY = Registry(registry_name="torch_tokenizer")


def arguments_tokenizer(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Tokenizer arguments")
    group.add_argument("--text-tokenizer.name", type=str, default=None)
    return TOKENIZER_REGISTRY.all_arguments(parser)


def build_tokenizer(opts, *args, **kwargs):
    return TOKENIZER_REGISTRY[getattr(opts, "text_tokenizer.name")](opts, *args, **kwargs)


# registers the ported tokenizers (after TOKENIZER_REGISTRY exists)
from cvnets_tpu_torch.data.text_tokenizer import clip_tokenizer  # noqa: E402,F401
