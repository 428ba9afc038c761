"""YAML config loading for the port's parser (counterpart of
cvnets_tpu/options/utils.py:20-79). ``yaml`` is imported inside
``load_config_file`` so the package imports without PyYAML."""

from __future__ import annotations

import argparse
import collections.abc
import os
import re
from typing import Any, Dict

from cvnets_tpu.utils import logger

DEFAULT_CONFIG_DIR = "config"
META_PARAMS_REGEX = r"tasks|include_configs"


def flatten_yaml_as_dict(d: Dict, parent_key: str = "", sep: str = ".") -> Dict[str, Any]:
    """Flatten nested mappings into dotted keys: {"a": {"b": 1}} -> {"a.b": 1}."""
    items = {}
    for k, v in d.items():
        new_key = f"{parent_key}{sep}{k}" if parent_key else k
        if isinstance(v, collections.abc.MutableMapping):
            items.update(flatten_yaml_as_dict(v, new_key, sep=sep))
        else:
            items[new_key] = v
    return items


def load_config_file(opts: argparse.Namespace) -> argparse.Namespace:
    """Apply ``--common.config-file`` and then ``--common.override-kwargs`` onto
    ``opts``. Keys the port's parser does not know are reported and skipped."""
    config_file_name = getattr(opts, "common.config_file", None)
    if config_file_name is not None:
        import yaml

        if not os.path.isfile(config_file_name):
            candidate = os.path.join(DEFAULT_CONFIG_DIR, config_file_name)
            if not os.path.isfile(candidate):
                logger.error(f"Configuration file does not exist at {config_file_name}")
            config_file_name = candidate
        setattr(opts, "common.config_file", config_file_name)
        with open(config_file_name) as yaml_file:
            cfg = yaml.load(yaml_file, Loader=yaml.FullLoader)
        for k, v in flatten_yaml_as_dict(cfg or {}).items():
            if hasattr(opts, k):
                setattr(opts, k, v)
            elif "local_" not in k and not re.match(META_PARAMS_REGEX, k):
                logger.warning(f"Yaml entry not supported by the port: {k}")

    for k, v in (getattr(opts, "override_args", None) or {}).items():
        if hasattr(opts, k):
            setattr(opts, k, v)
        else:
            logger.warning(f"Unrecognized override entry: {k}")
    return opts
