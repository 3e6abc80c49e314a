"""Method registry lookup and option plumbing (counterpart of
xitorch_tpu/utils/misc.py).

Each functional accepts a method *string* (registry lookup) or a
user-supplied *callable* with the same signature as the built-in methods.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence, Tuple, Union

import torch

__all__ = ["get_method", "partition_params", "set_default_option", "get_and_pop_keys",
           "dummy_context_manager"]


def set_default_option(defopt: Mapping[str, Any], opt: Mapping[str, Any]) -> Dict[str, Any]:
    """Return a dict with ``defopt`` keys overridden by ``opt``."""
    res = dict(defopt)
    res.update(opt)
    return res


def get_and_pop_keys(dct: Dict[str, Any], keys: Sequence[str]) -> Dict[str, Any]:
    """Remove ``keys`` from ``dct`` in place and return them as a new dict."""
    return {k: dct.pop(k) for k in keys}


def partition_params(params: Sequence[Any]) -> Tuple[tuple, Callable]:
    """Split ``params`` into the floating-point tensors (the ones a
    gradient can reach) and everything else, with the function that merges
    a sequence of tensors back into the original order (counterpart of
    ``_partition_params`` in xitorch_tpu/optimize/rootfinder.py, where the
    dynamic members are arrays and Python floats; here a Python float is
    static, since no gradient reaches it)."""
    dyn, layout, static = [], [], []
    for p in params:
        if torch.is_tensor(p) and (p.is_floating_point() or p.is_complex()):
            layout.append((True, len(dyn)))
            dyn.append(p)
        else:
            layout.append((False, len(static)))
            static.append(p)

    def merge(dynparams):
        return tuple(dynparams[i] if is_dyn else static[i] for is_dyn, i in layout)

    return tuple(dyn), merge


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


class dummy_context_manager:
    """A context manager that does nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *args):
        return None
