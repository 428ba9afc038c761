"""YAML config loading for the port's parser and the flag clones of
distillation's teacher (counterpart of cvnets_tpu/options/utils.py:20-184).
``yaml`` is imported inside ``load_config_file`` so the package imports
without PyYAML. A yaml list (``loss.composite_loss``) reaches the namespace
as the list."""

from __future__ import annotations

import argparse
import collections.abc
import os
import re
from typing import Any, Dict

from cvnets_tpu_torch.utils import logger

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


def extend_selected_args_with_prefix(parser: argparse.ArgumentParser, match_prefix: str,
                                     additional_prefix: str) -> argparse.ArgumentParser:
    """Clone every flag of ``parser`` that starts with ``match_prefix`` under
    ``additional_prefix`` (``--model.*`` as ``--teacher.model.*``, for the
    distillation teacher; options/utils.py:103-148). A store-true flag's clone
    takes an optional value (``nargs="?"``, const True)."""
    regexp = r"--[^_]+\."
    assert re.match(regexp, match_prefix), match_prefix
    assert re.match(regexp, additional_prefix), additional_prefix
    for action in list(parser._actions):
        for option_string in action.option_strings:
            if option_string.startswith(match_prefix):
                parser.add_argument(
                    option_string.replace(match_prefix, additional_prefix),
                    nargs="?" if isinstance(action, argparse._StoreTrueAction)
                    else action.nargs,
                    const=action.const, default=action.default, type=action.type,
                    choices=action.choices, help=action.help, metavar=action.metavar)
    return parser


def extract_opts_with_prefix_replacement(opts: argparse.Namespace, match_prefix: str,
                                         replacement_prefix: str) -> argparse.Namespace:
    """A namespace of the options of ``opts`` that start with ``match_prefix``,
    renamed to start with ``replacement_prefix`` (``teacher.model.*`` back to
    ``model.*``; options/utils.py:151-184)."""
    regexp = r"[^-]+\."
    assert re.match(regexp, match_prefix), match_prefix
    assert re.match(regexp, replacement_prefix), replacement_prefix
    return argparse.Namespace(**{k.replace(match_prefix, replacement_prefix, 1): v
                                 for k, v in vars(opts).items() if k.startswith(match_prefix)})
