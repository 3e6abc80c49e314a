"""Deprecation decorator (counterpart of xitorch_tpu/utils/decorators.py)."""
from __future__ import annotations

import functools
import warnings

__all__ = ["deprecated"]


def deprecated(date_str: str):
    """Mark a function or class deprecated since ``date_str``."""
    def decorator(obj):
        msg = "%s has been deprecated since %s" % (
            getattr(obj, "__name__", str(obj)), date_str)
        if isinstance(obj, type):
            orig_init = obj.__init__

            @functools.wraps(orig_init)
            def new_init(self, *args, **kwargs):
                warnings.warn(msg, DeprecationWarning, stacklevel=2)
                orig_init(self, *args, **kwargs)

            obj.__init__ = new_init
            return obj

        @functools.wraps(obj)
        def wrapper(*args, **kwargs):
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return obj(*args, **kwargs)

        return wrapper
    return decorator
