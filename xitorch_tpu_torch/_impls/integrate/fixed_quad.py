"""Fixed-order quadrature rules (counterpart of
xitorch_tpu/_impls/integrate/fixed_quad.py).

The integrand runs once on all nodes through ``torch.func.vmap`` (as the
JAX package ``jax.vmap``s it), followed by one weighted reduction a leaf.
The nodes and weights are computed on the host with numpy and moved to the
device once a call.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from xitorch_tpu_torch.utils.pytree import tree_map
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["leggauss", "tanhsinh"]


def _weighted_sum(fcn, xs, ws, params):
    ys = vmap(lambda x: fcn(x, *params))(xs)  # leaves with a leading n
    return tree_map(lambda y: einsum_hi("n,n...->...", ws.to(y.dtype), y), ys)


def leggauss(fcn, xl, xu, params, n: int = 100, **unused):
    """n-point Gauss-Legendre quadrature of ``fcn(x, *params)`` over
    [xl, xu] (tensors of one element, of the dtype and device of the
    integral).  fcn may return a tensor or a dict/tuple/list of tensors;
    differentiable to any order by autograd through the node sum.

    Keyword arguments
    -----------------
    n: int
        The number of integration points.
    """
    xlg_np, wlg_np = np.polynomial.legendre.leggauss(n)
    xlg = torch.as_tensor(xlg_np, dtype=xl.dtype, device=xl.device)
    wlg = torch.as_tensor(wlg_np, dtype=xl.dtype, device=xl.device)
    half = 0.5 * (xu - xl)
    mid = 0.5 * (xu + xl)
    return _weighted_sum(fcn, xlg * half + mid, wlg * half, params)


def tanhsinh(fcn, xl, xu, params, n: int = 121, **unused):
    """n-point tanh-sinh (double-exponential) quadrature over [xl, xu].

    The substitution x = mid + half*tanh(pi/2 * sinh(t)) pushes the
    endpoints infinitely far away in t, so endpoint singularities
    integrable in the Riemann sense (1/sqrt(x), log(x), ...) converge
    exponentially where Gauss-Legendre creeps polynomially.  The node
    nearest an endpoint sits ~2e-14 (float64) / ~1e-7 (float32) away
    relative to the interval, so fcn is never evaluated exactly at a finite
    singular endpoint.

    Keyword arguments
    -----------------
    n: int
        The number of integration points (level h = 2*t_max/(n-1)).
    """
    # t_max: where the DE weight underflows the dtype (and the node
    # distance to the endpoint stays representable)
    t_max = 3.0 if torch.finfo(xl.dtype).bits >= 64 else 2.3
    t = np.linspace(-t_max, t_max, n)
    h = t[1] - t[0]
    st = np.pi / 2.0 * np.sinh(t)
    xs01 = np.tanh(st)                                   # in (-1, 1)
    wts = h * (np.pi / 2.0) * np.cosh(t) / np.cosh(st) ** 2
    half = 0.5 * (xu - xl)
    mid = 0.5 * (xu + xl)
    xs = torch.as_tensor(xs01, dtype=xl.dtype, device=xl.device) * half + mid
    ws = torch.as_tensor(wts, dtype=xl.dtype, device=xl.device) * half
    return _weighted_sum(fcn, xs, ws, params)
