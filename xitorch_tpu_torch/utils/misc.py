"""Method registry lookup (counterpart of ``get_method`` in
xitorch_tpu/utils/misc.py).

Each functional accepts a method *string* (registry lookup) or a
user-supplied *callable* with the same signature as the built-in methods.
"""
from __future__ import annotations

from typing import Callable, Mapping, Union

__all__ = ["get_method"]


def get_method(algname: str, methods: Mapping[str, Callable],
               method: Union[str, Callable]) -> Callable:
    """Resolve a method string (registry lookup) or pass a callable through."""
    if isinstance(method, str):
        methodl = method.lower()
        if methodl in methods:
            return methods[methodl]
        raise RuntimeError(
            "Unknown %s method: %s. Available methods: %s"
            % (algname, method, ", ".join(sorted(methods.keys())))
        )
    elif callable(method):
        return method
    raise TypeError(
        "Invalid method type: %s for %s. Only str and callable are accepted."
        % (type(method), algname)
    )
