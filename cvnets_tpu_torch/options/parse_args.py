"""``--common.override-kwargs`` parsing: a copy of ``ParseKwargs`` from
cvnets_tpu/options/parse_args.py."""

from __future__ import annotations

import argparse
from typing import Any, Dict


class ParseKwargs(argparse.Action):
    """Parses ``k1=v1 k2=v2`` into ``namespace.override_args`` with YAML-like
    scalar coercion: booleans, none, int, float, comma lists, else the string."""

    @staticmethod
    def _coerce(value: str) -> Any:
        lowered = value.lower()
        if lowered in ("true", "yes"):
            return True
        if lowered in ("false", "no"):
            return False
        if lowered in ("none", "null"):
            return None
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
        if "," in value:
            return [ParseKwargs._coerce(v) for v in value.split(",") if v != ""]
        return value

    def __call__(self, parser, namespace, values, option_string=None):
        out: Dict[str, Any] = {}
        for item in values:
            if "=" not in item:
                raise argparse.ArgumentTypeError(
                    f"override-kwargs entries must look like key=value; got {item!r}")
            k, v = item.split("=", 1)
            out[k.strip()] = self._coerce(v.strip())
        setattr(namespace, "override_args", out)
