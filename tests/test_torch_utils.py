"""The port's own copies of the JAX package's helpers that import no JAX
(``utils/registry.py``, ``utils/logger.py``, ``utils/math_utils.py``,
``options/parse_args.py``) behave as the originals on what the port relies on:
an unknown registry key raises ``LoggerError`` naming what exists, a key with
arguments gives a ``functools.partial``, a duplicate or a class outside the base
class raises ``ValueError``; override kwargs coerce alike; channel rounding
agrees. Each case runs against both packages."""

from __future__ import annotations

import argparse
import functools

import pytest

PACKAGES = ["cvnets_tpu_torch", "cvnets_tpu"]


def _registry_and_error(package):
    if package == "cvnets_tpu":
        from cvnets_tpu.utils.logger import LoggerError
        from cvnets_tpu.utils.registry import Registry
    else:
        from cvnets_tpu_torch.utils.logger import LoggerError
        from cvnets_tpu_torch.utils.registry import Registry
    return Registry, LoggerError


class _Base:
    pass


@pytest.mark.parametrize("package", PACKAGES)
def test_registry_unknown_key_raises_logger_error_naming_what_exists(package):
    Registry, LoggerError = _registry_and_error(package)
    reg = Registry("probe", base_class=_Base)

    @reg.register("known", type="kind")
    class Known(_Base):
        pass

    assert reg["known", "kind"] is Known and ("known", "kind") in reg
    assert ("other", "kind") not in reg
    with pytest.raises(LoggerError):
        reg["other", "kind"]
    assert isinstance(LoggerError("x"), SystemExit)


@pytest.mark.parametrize("package", PACKAGES)
def test_registry_key_arguments_give_a_partial(package):
    Registry, _ = _registry_and_error(package)
    reg = Registry("probe")

    @reg.register("d")
    def make(name, type):
        return name, type

    item = reg["d(name=hello, type=fifo)"]
    assert isinstance(item, functools.partial)
    assert item() == ("hello", "fifo")


@pytest.mark.parametrize("package", PACKAGES)
def test_registry_duplicate_or_foreign_class_raises_value_error(package):
    Registry, _ = _registry_and_error(package)
    reg = Registry("probe", base_class=_Base)

    @reg.register("a")
    class First(_Base):
        pass

    with pytest.raises(ValueError, match="duplicate"):
        @reg.register("a")
        class Second(_Base):
            x = 1

    with pytest.raises(ValueError, match="must extend"):
        @reg.register("b")
        class Foreign:
            pass


@pytest.mark.parametrize("value", ["true", "No", "none", "NULL", "3", "-7", "2.5", "1e-4",
                                   "1,2,x", "a,,b", "abc"])
def test_override_kwargs_coerce_as_the_jax_parser(value):
    from cvnets_tpu.options.parse_args import ParseKwargs as JaxParseKwargs
    from cvnets_tpu_torch.options.parse_args import ParseKwargs

    got, want = argparse.Namespace(), argparse.Namespace()
    ParseKwargs(["--k"], "k")(None, got, [f"key={value}"])
    JaxParseKwargs(["--k"], "k")(None, want, [f"key={value}"])
    assert got.override_args == want.override_args


def test_override_kwargs_reject_an_entry_without_a_value():
    from cvnets_tpu_torch.options.parse_args import ParseKwargs

    with pytest.raises(argparse.ArgumentTypeError, match="key=value"):
        ParseKwargs(["--k"], "k")(None, argparse.Namespace(), ["novalue"])


@pytest.mark.parametrize("v,divisor,min_value", [(32 * 0.75, 8, None), (17, 8, None),
                                                  (3.9, 8, None), (100, 16, 32),
                                                  (1000.4, 8, None), (12, 4, 16)])
def test_channel_rounding_matches_jax(v, divisor, min_value):
    from cvnets_tpu.utils.math_utils import bound_fn as jax_bound_fn
    from cvnets_tpu.utils.math_utils import make_divisible as jax_make_divisible
    from cvnets_tpu_torch.utils.math_utils import bound_fn, make_divisible

    assert make_divisible(v, divisor, min_value) == jax_make_divisible(v, divisor, min_value)
    assert bound_fn(4, 64, v) == jax_bound_fn(4, 64, v)


def test_logger_error_prints_and_raises(capsys):
    from cvnets_tpu_torch.utils import logger

    logger.info("shown")
    with pytest.raises(logger.LoggerError, match="broken"):
        logger.error("broken")
    out, err = capsys.readouterr()
    assert "shown" in out and "broken" in err
