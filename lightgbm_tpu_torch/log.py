"""Leveled logging with a pluggable callback.

Mirrors the reference logger (include/LightGBM/utils/log.h:88): levels
Debug/Info/Warning/Fatal keyed off the `verbosity` (alias `verbose`)
config value, with a registerable redirection callback
(log.h:97, python-package basic.py register_logger).
"""

from __future__ import annotations

import sys
from typing import Any, Optional

_logger: Optional[Any] = None
_info_method = "info"
_warning_method = "warning"
_debug_method: Optional[str] = None

# verbosity: <0 Fatal only, 0 Warning, 1 Info (default), >=2 Debug.
# The gate applies before any emission path — a REGISTERED logger is
# filtered exactly like the default stream output (fatal-only
# verbosity silences info/warning/debug for both; log.h:88 keys every
# sink off the same level).
_VERBOSITY = 1


class LightGBMError(Exception):
    """Error raised by lightgbm_tpu_torch (reference: include/LightGBM/utils/log.h Fatal)."""


def register_logger(
    logger: Any,
    info_method_name: str = "info",
    warning_method_name: str = "warning",
    debug_method_name: Optional[str] = None,
) -> None:
    """Redirect framework log output to a custom logger object.

    Debug lines route to `debug_method_name` when given, else to a
    callable ``debug`` attribute when the logger has one (the
    stdlib-logging shape), else through the info method."""
    global _logger, _info_method, _warning_method, _debug_method
    if not callable(getattr(logger, info_method_name, None)):
        raise TypeError(f"logger has no callable method {info_method_name!r}")
    if not callable(getattr(logger, warning_method_name, None)):
        raise TypeError(f"logger has no callable method {warning_method_name!r}")
    if debug_method_name is not None and not callable(
        getattr(logger, debug_method_name, None)
    ):
        raise TypeError(f"logger has no callable method {debug_method_name!r}")
    _logger = logger
    _info_method = info_method_name
    _warning_method = warning_method_name
    if debug_method_name is not None:
        _debug_method = debug_method_name
    elif callable(getattr(logger, "debug", None)):
        _debug_method = "debug"
    else:
        _debug_method = None


def set_verbosity(v: int) -> None:
    global _VERBOSITY
    _VERBOSITY = int(v)


def _emit(msg: str, warning: bool = False, debug: bool = False) -> None:
    if _logger is not None:
        if debug and _debug_method is not None:
            method = _debug_method
        elif warning:
            method = _warning_method
        else:
            method = _info_method
        getattr(_logger, method)(msg)
    else:
        print(msg, file=sys.stderr if warning else sys.stdout, flush=True)


def debug(msg: str) -> None:
    if _VERBOSITY >= 2:
        _emit(f"[LightGBM-TPU] [Debug] {msg}", debug=True)


def info(msg: str) -> None:
    if _VERBOSITY >= 1:
        _emit(f"[LightGBM-TPU] [Info] {msg}")


def warning(msg: str) -> None:
    if _VERBOSITY >= 0:
        _emit(f"[LightGBM-TPU] [Warning] {msg}", warning=True)


def fatal(msg: str) -> None:
    raise LightGBMError(msg)
