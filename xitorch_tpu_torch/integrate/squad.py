"""SQuad: quadrature of fixed samples, cumulative and full (counterpart of
xitorch_tpu/integrate/squad.py).

The object builds its (nx, nx) weight matrices at construction; cumsum and
integrate are then contractions in IEEE float32 (never TF32),
differentiable through both the samples y and the positions x.  It runs
on the device of ``x``; ``y`` on another device raises.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from xitorch_tpu_torch._impls.integrate.samples_quad import (
    CubicSplineSQuad, SimpsonSQuad, TrapzSQuad,
)
from xitorch_tpu_torch._impls.interpolate.interp_1d import check_same_device
from xitorch_tpu_torch.utils.misc import get_method

__all__ = ["SQuad"]

_SQUAD_METHODS = {
    "cspline": CubicSplineSQuad,
    "simpson": SimpsonSQuad,
    "trapz": TrapzSQuad,
}


class SQuad:
    r"""Sampled QUADrature: :math:`\mathbf{z}(x) = \int_{x_0}^{x}
    \mathbf{y}(x')\,dx'` where y is interpolated from samples at ``x``.

    Arguments
    ---------
    x: (nx,) sample positions (1D).
    method: "cspline" (default; option bc_type), "simpson", "trapz", or a
        custom class with (x, **options) -> object with cumsum/integrate.

    Examples
    --------
    >>> import torch
    >>> from xitorch_tpu_torch.integrate import SQuad
    >>> x = torch.linspace(0.0, 1.0, 101, dtype=torch.float64)
    >>> bool((SQuad(x).integrate(x * x) - 1.0 / 3.0).abs() < 1e-6)
    True
    """

    def __init__(self, x: torch.Tensor, method: Union[str, Callable, None] = None,
                 **fwd_options):
        if method is None:
            method = "cspline"
        if x.dim() != 1:
            raise RuntimeError("The input x to SQuad must be a 1D tensor")
        clss = get_method("SQuad", _SQUAD_METHODS, method)
        self.obj = clss(x, **fwd_options)
        self.nx = x.shape[-1]
        self._x = x

    def _to_last(self, y: torch.Tensor, dim: int):
        check_same_device("SQuad", self._x, y)
        swap = dim not in (-1, y.dim() - 1)
        if swap:
            y = torch.swapaxes(y, dim, -1)
        if y.shape[-1] != self.nx:
            raise RuntimeError("The length of integrated dimension does not match with x")
        return y, swap

    def cumsum(self, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Cumulative integration of samples ``y`` along ``dim``."""
        y, swap = self._to_last(y, dim)
        res = self.obj.cumsum(y)
        return torch.swapaxes(res, dim, -1) if swap else res

    def integrate(self, y: torch.Tensor, dim: int = -1,
                  keepdim: bool = False) -> torch.Tensor:
        """Full integration of samples ``y`` along ``dim``."""
        y, swap = self._to_last(y, dim)
        res = self.obj.integrate(y)
        if keepdim:
            res = res[..., None]
            if swap:
                res = torch.swapaxes(res, dim, -1)
        elif swap:
            # the former last axis was parked at position ``dim`` by the
            # swap; after the reduction it moves back to the end, or the
            # result comes out axis-permuted
            res = torch.movedim(res, dim % (res.dim() + 1), -1)
        return res
