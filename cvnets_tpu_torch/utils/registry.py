"""Name → class registry behind the port's flags: a copy of the parts of
cvnets_tpu/utils/registry.py that the port uses.

* ``register(name, type)`` stores under ``"type:name"``; ``registry[(name, type)]``
  looks it up and an unknown key raises ``LoggerError`` listing what exists.
* ``registry["name(k=v, ...)"]`` returns a ``functools.partial`` with the keys.
* A second registration under one key, or a class outside ``base_class``, raises
  ``ValueError``.
* ``all_arguments(parser)`` calls every registered item's ``add_arguments``.

The port's modules register at import (no lazy directory loading).
"""

from __future__ import annotations

import argparse
import re
from functools import partial
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

from cvnets_tpu_torch.utils import logger

_KEY_WITH_ARGS = re.compile(r"^(?P<name>[^()]+)(\((?P<args>.*)\))?$")


class Registry:
    def __init__(self, registry_name: str, base_class: Optional[type] = None,
                 separator: str = ":") -> None:
        self.registry_name = registry_name
        self.base_class = base_class
        self.separator = separator
        self._items: Dict[str, Callable] = {}

    def register(self, name: str, type: str = "") -> Callable:
        full_name = f"{type}{self.separator}{name}" if type else name

        def _decorator(item: Callable) -> Callable:
            if full_name in self._items:
                raise ValueError(f"Cannot register duplicate {self.registry_name} "
                                 f"({full_name})")
            if (self.base_class is not None and isinstance(item, builtins_type)
                    and not issubclass(item, self.base_class)):
                raise ValueError(f"{self.registry_name} class ({full_name}: "
                                 f"{item.__name__}) must extend {self.base_class.__name__}")
            self._items[full_name] = item
            return item

        return _decorator

    @staticmethod
    def parse_key(key: str) -> Tuple[str, Dict[str, str]]:
        """Split ``"name(a=1, b=2)"`` into ("name", {"a": "1", "b": "2"})."""
        m = _KEY_WITH_ARGS.match(key.strip())
        if m is None:
            logger.error(f"Could not parse registry key `{key}`.")
        params: Dict[str, str] = {}
        for piece in (m.group("args") or "").split(","):
            if not piece.strip():
                continue
            if "=" not in piece:
                logger.error(f"Malformed key parameters in `{key}`; expected "
                             "name(arg1=value1, arg2=value2, ...).")
            k, v = piece.split("=", 1)
            params[k.strip()] = v.strip()
        return m.group("name").strip(), params

    def _full_name(self, key: Union[Tuple[str, str], str]) -> Tuple[str, Dict[str, str]]:
        type_ = None
        if isinstance(key, tuple) and len(key) == 2:
            key, type_ = key
        if not isinstance(key, str):
            logger.error(f"Registry key should be a string; got {builtins_type(key)}")
        name, params = self.parse_key(key)
        return (f"{type_}{self.separator}{name}" if type_ else name), params

    def __getitem__(self, key: Union[Tuple[str, str], str]) -> Callable:
        name, params = self._full_name(key)
        if name not in self._items:
            supported = "\n\t".join(sorted(self._items))
            logger.error(f"`{name}` not supported in {self.registry_name} registry. "
                         f"Supported:\n\t{supported}")
        item = self._items[name]
        return partial(item, **params) if params else item

    def __contains__(self, key: Union[Tuple[str, str], str]) -> bool:
        return self._full_name(key)[0] in self._items

    def items(self) -> Iterable[Tuple[str, Callable]]:
        return self._items.items()

    def keys(self) -> Iterable[str]:
        return self._items.keys()

    def all_arguments(self, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        seen = set()  # an item registered under two names adds its flags once
        for item in self._items.values():
            if id(item) in seen:
                continue
            seen.add(id(item))
            add_args = getattr(item, "add_arguments", None)
            if add_args is not None:
                parser = add_args(parser)
        return parser


# ``type`` is a parameter name of ``register`` (the JAX package's signature)
builtins_type = type
