"""Process-global debug mode (counterpart of xitorch_tpu/debug/modes.py).

Enabling debug mode turns on expensive eager checks
(``LinearOperator.check``) inside the public API entry points.
"""
from __future__ import annotations

from contextlib import contextmanager

__all__ = ["set_debug_mode", "is_debug_enabled", "enable_debug", "disable_debug"]

_DEBUG = {"enabled": False}


def set_debug_mode(mode: bool) -> None:
    _DEBUG["enabled"] = bool(mode)


def is_debug_enabled() -> bool:
    return _DEBUG["enabled"]


@contextmanager
def enable_debug():
    prev = is_debug_enabled()
    set_debug_mode(True)
    try:
        yield
    finally:
        set_debug_mode(prev)


@contextmanager
def disable_debug():
    prev = is_debug_enabled()
    set_debug_mode(False)
    try:
        yield
    finally:
        set_debug_mode(prev)
