"""Coloured logging for the port: a copy of the parts of cvnets_tpu/utils/logger.py
that the port uses. ``error`` prints and raises ``LoggerError`` (a ``SystemExit``),
so it never returns."""

from __future__ import annotations

import sys
import time
import traceback
from typing import Any

_COLORS = {"reset": "\033[0m", "red": "\033[31m", "green": "\033[32m",
           "yellow": "\033[33m", "cyan": "\033[36m"}


_QUIET = False


def set_quiet(quiet: bool) -> None:
    """Silence ``log`` and ``info`` (a data-parallel rank other than the
    master's); warnings and errors still print."""
    global _QUIET
    _QUIET = quiet


def _emit(tag: str, color: str, message: Any, stream=None) -> None:
    prefix = f"{_COLORS[color]}{tag}{_COLORS['reset']}"
    print(f"{time.strftime('%Y-%m-%d %H:%M:%S')} - {prefix} - {message}",
          file=stream or sys.stdout, flush=True)


def log(message: Any) -> None:
    if not _QUIET:
        _emit("LOGS   ", "cyan", message)


def info(message: Any) -> None:
    if not _QUIET:
        _emit("INFO   ", "green", message)


def warning(message: Any) -> None:
    _emit("WARNING", "yellow", message, stream=sys.stderr)


class LoggerError(SystemExit):
    """Raised by :func:`error`; a ``SystemExit``, so an uncaught error ends the
    program."""


def error(message: Any) -> None:
    """Print the message and the caller's stack, then raise ``LoggerError``."""
    _emit("ERROR  ", "red", message, stream=sys.stderr)
    print("".join(traceback.format_stack(limit=8)[:-1]), file=sys.stderr, flush=True)
    raise LoggerError(f"cvnets_tpu_torch error: {message}")
