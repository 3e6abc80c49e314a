"""Interp1D: differentiable 1-D interpolation (counterpart of
xitorch_tpu/interpolate/interp1.py).

Sorts unsorted knots (keeping the permutation, which is applied to a ``y``
given at call time too), dispatches to the cubic-spline, PCHIP or linear
kernels of ``_impls/interpolate/interp_1d.py``, and is callable with ``xq``
(and ``y`` if it was not given at construction).  Runs on the device of
the tensors given; ``x``, ``y`` and ``xq`` on different devices raise.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from xitorch_tpu_torch._impls.interpolate.interp_1d import (
    CubicSpline1D, LinearInterp1D, Pchip1D, check_same_device,
)
from xitorch_tpu_torch.utils.misc import get_method

__all__ = ["Interp1D"]

_INTERP1_METHODS = {
    "cspline": CubicSpline1D,
    "pchip": Pchip1D,
    "linear": LinearInterp1D,
}


class Interp1D:
    """1-D interpolation of ``y`` sampled at ``x`` (last dimension).

    Arguments
    ---------
    x: (*BX, nr) positions (sorted along the last dim or sortable).
    y: (*BY, nr) values, or None to supply at call time.
    method: "cspline" (default; options bc_type, extrap, use_tridiag),
        "pchip" (monotone cubic), or "linear" (option extrap), or a custom
        class.

    Examples
    --------
    >>> import torch
    >>> from xitorch_tpu_torch.interpolate import Interp1D
    >>> x = torch.linspace(0.0, 1.0, 16, dtype=torch.float64)
    >>> f = Interp1D(x, torch.sin(3 * x))
    >>> q = torch.tensor([0.45], dtype=torch.float64)
    >>> bool((f(q)[0] - torch.sin(3 * q[0])).abs() < 1e-4)
    True
    """

    def __init__(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                 method: Union[str, Callable, None] = None, **fwd_options):
        if method is None:
            method = "cspline"
        clss = get_method("Interp1D", _INTERP1_METHODS, method)
        check_same_device("Interp1D", x, y)

        # sort if needed; the check reads one value back from the device
        self._sort_idx = None
        if not bool((x[..., 1:] >= x[..., :-1]).all()):
            idx = torch.argsort(x, dim=-1, stable=True)
            x = torch.gather(x, -1, idx)
            # keep the permutation: a y given at call time is gathered the
            # same way
            self._sort_idx = idx
            if y is not None:
                y = self._permute_y(y)

        self.obj = clss(x, y, **fwd_options)

    def _permute_y(self, y):
        idx = self._sort_idx
        shape = torch.broadcast_shapes(y.shape, idx.shape)
        return torch.gather(y.expand(shape), -1, idx.expand(shape))

    def __call__(self, xq: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Interpolate at query points xq (*BX, nrq) -> (*BXY, nrq)."""
        if y is not None and self._sort_idx is not None:
            check_same_device("Interp1D", self._sort_idx, y)
            y = self._permute_y(y)
        return self.obj(xq, y)
