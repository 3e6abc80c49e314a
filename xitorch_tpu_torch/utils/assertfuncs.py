"""Debug-gated input validation helpers (counterpart of
xitorch_tpu/utils/assertfuncs.py).

A user callable whose signature or output shape does not match what a
functional expects would otherwise fail deep inside a solver loop.  Under
debug mode the API entry points call :func:`assert_fcn_params`, which
evaluates the callable once on the given inputs (without gradients) and
raises a ``RuntimeError`` naming the callable and the expected and actual
shapes.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["assert_runtime", "assert_type", "assert_broadcastable",
           "assert_fcn_params"]


def assert_runtime(cond, msg: str = "") -> None:
    if not cond:
        raise RuntimeError(msg)


def assert_type(cond, msg: str = "") -> None:
    if not cond:
        raise TypeError(msg)


def assert_broadcastable(shape1, shape2) -> None:
    """Raise if two batch shapes cannot broadcast."""
    if len(shape1) > len(shape2):
        assert_broadcastable(shape2, shape1)
        return
    for a, b in zip(shape1[::-1], shape2[::-1][:len(shape1)]):
        assert_runtime(a == 1 or b == 1 or a == b,
                       "The shape %s and %s are not broadcastable"
                       % (tuple(shape1), tuple(shape2)))


def _shapes(obj):
    if torch.is_tensor(obj):
        return tuple(obj.shape)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_shapes(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _shapes(v) for k, v in obj.items()}
    return ()


def assert_fcn_params(fcn, args, what: str = "fcn",
                      expect_like: Optional[object] = None) -> None:
    """Validate that ``fcn(*args)`` evaluates (and, if ``expect_like`` is
    given, that its output has that object's structure and shapes).  One
    evaluation without gradients; called from the API entry points when
    debug mode is enabled."""
    try:
        # enable_grad: a callable may take derivatives inside (minimize's
        # objectives, hess); the result is not kept
        with torch.enable_grad():
            out = fcn(*args)
    except Exception as e:
        raise RuntimeError(
            "%s(%s) failed to evaluate with the given inputs (arg shapes: "
            "%s). Check the callable's signature and the params list.\n"
            "Underlying error: %s" % (what, getattr(fcn, "__name__", "fcn"),
                                      _shapes(tuple(args)), e)) from e
    if expect_like is not None and _shapes(out) != _shapes(expect_like):
        raise RuntimeError(
            "%s output does not match the expected structure: got shapes %s, "
            "expected %s" % (what, _shapes(out), _shapes(expect_like)))
