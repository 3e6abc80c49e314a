"""Initial value problem (ODE) solver (counterpart of
xitorch_tpu/integrate/solve_ivp.py).

* The default adjoint is autograd through the solver's steps: exact for
  the discrete solution, any order, and ``torch.func.vmap``-able (the
  adaptive methods then keep one step size a trajectory).
* ``adjoint="backsolve"``: the continuous adjoint, O(1) memory in the
  number of steps, first order only (``integrate/_adjoint.py``).
* ``y0`` may be a tensor or a dict/tuple/list of tensors
  (``utils/pytree.py``); the adaptive and implicit methods ravel it.

Methods: "rk45" (default), "rk23" (adaptive, options atol/rtol/max_steps),
"rk4", "rk38", "mid_point", "euler" (fixed-step explicit), "bwd_euler",
"trapezoidal", "sdirk2" (fixed-step implicit, for stiff systems), or a
custom callable ``(fcn, ts, y0, params, **cfg)``.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence, Union

import torch

from xitorch_tpu_torch._impls.integrate.adaptive_rk import rk23_adaptive, rk45_adaptive
from xitorch_tpu_torch._impls.integrate.explicit_rk import (
    fwd_euler_ivp, mid_point_ivp, rk38_ivp, rk4_ivp,
)
from xitorch_tpu_torch._impls.integrate.implicit_rk import (
    bwd_euler_ivp, sdirk2_ivp, trapezoidal_ivp,
)
from xitorch_tpu_torch.debug.modes import is_debug_enabled
from xitorch_tpu_torch.utils.assertfuncs import assert_fcn_params
from xitorch_tpu_torch.utils.misc import get_method, partition_params
from xitorch_tpu_torch.utils.pytree import ravel_pytree

__all__ = ["solve_ivp"]

_IVP_METHODS = {
    "rk45": rk45_adaptive,
    "rk23": rk23_adaptive,
    "rk4": rk4_ivp,
    "rk38": rk38_ivp,
    "mid_point": mid_point_ivp,
    "euler": fwd_euler_ivp,
    "bwd_euler": bwd_euler_ivp,
    "trapezoidal": trapezoidal_ivp,
    "sdirk2": sdirk2_ivp,
}

_ADAPTIVE = {"rk45", "rk23"}


def _flat_fcn(fcn: Callable, unravel: Callable, merge: Callable = tuple) -> Callable:
    def fcn_flat(t, yf, *ps):
        return ravel_pytree(fcn(t, unravel(yf), *merge(ps)))[0]
    return fcn_flat


def solve_ivp(fcn: Callable, ts: torch.Tensor, y0,
              params: Sequence[Any] = (),
              bck_options: Mapping[str, Any] = {},
              method: Union[str, Callable, None] = None,
              adjoint: str = "autodiff",
              return_info: bool = False,
              **fwd_options):
    r"""Solve dy/dt = fcn(t, y, *params) from y(ts[0]) = y0, returning y at
    every t in ``ts`` with shape ``(nt, *ny)`` (the leaves of a dict, tuple
    or list ``y0`` gain a leading nt).  ``ts`` must be monotonic (1D); the
    computation runs on the device of ``ts`` and ``y0``.

    adjoint: "autodiff" (default: autograd through the solver, exact for
    the discrete solution, any order, vmappable) or "backsolve" (the
    continuous adjoint: O(1) memory, first order only).

    With ``return_info=True`` (autodiff adjoint only), returns ``(yt,
    info)`` where info holds float32 tensors: for the adaptive methods
    ``{"converged"`` (the step budget covered all output times),
    ``"iterations"`` (accepted steps), ``"rejected"}``; trivially complete
    for fixed-step methods.

    Examples
    --------
    >>> import torch
    >>> from xitorch_tpu_torch.integrate import solve_ivp
    >>> ts = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    >>> yt = solve_ivp(lambda t, y, a: -a * y, ts, torch.ones(1, dtype=torch.float64),
    ...                params=(torch.tensor(2.0, dtype=torch.float64),))
    >>> bool((yt[:, 0] - torch.exp(-2.0 * ts)).abs().max() < 1e-5)
    True
    """
    if ts.ndim != 1:
        raise RuntimeError("Argument ts must be a 1D tensor")
    if method is None:
        method = "rk45"
    if is_debug_enabled():
        assert_fcn_params(fcn, (ts[0], y0, *params), what="solve_ivp fcn",
                          expect_like=y0)
    solver = get_method("solve_ivp", _IVP_METHODS, method)

    if return_info and adjoint != "autodiff":
        raise RuntimeError("return_info=True requires adjoint='autodiff'")
    if adjoint == "backsolve":
        from xitorch_tpu_torch.integrate._adjoint import backsolve_ivp

        dynparams, merge = partition_params(params)
        y0flat, unravel = ravel_pytree(y0)
        ytflat = backsolve_ivp(solver, _flat_fcn(fcn, unravel, merge), ts, y0flat,
                               dynparams, **fwd_options)
        return unravel(ytflat)
    if adjoint != "autodiff":
        raise RuntimeError("Unknown adjoint mode: %s" % adjoint)

    is_adaptive = isinstance(method, str) and method in _ADAPTIVE
    if return_info and is_adaptive:
        fwd_options = dict(fwd_options, return_info=True)

    if is_adaptive and not torch.is_tensor(y0):
        # the adaptive steppers work on flat tensors: ravel the tree through
        y0flat, unravel = ravel_pytree(y0)
        out = solver(_flat_fcn(fcn, unravel), ts, y0flat, params, **fwd_options)
        ytflat, info = out if return_info else (out, None)
        yt = unravel(ytflat)
        return (yt, info) if return_info else yt

    out = solver(fcn, ts, y0, params, **fwd_options)
    if return_info and not is_adaptive:
        # fixed-step (or custom) methods take exactly nt-1 deterministic steps
        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=ts.device)
        return out, {"converged": f32(1.0), "iterations": f32(ts.shape[0] - 1),
                     "rejected": f32(0.0)}
    return out


# docstring completion
from xitorch_tpu_torch._docstr.api_docstr import get_methods_docstr  # noqa: E402

solve_ivp.__doc__ = get_methods_docstr(solve_ivp, _IVP_METHODS)
