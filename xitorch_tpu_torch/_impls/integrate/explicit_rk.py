"""Fixed-step explicit Runge-Kutta integrators (counterpart of
xitorch_tpu/_impls/integrate/explicit_rk.py).

The same Butcher tableaus (rk4, rk38, Euler, midpoint); the ``lax.scan``
over time intervals becomes a Python loop over them with the (small,
static) stage loop unrolled.  Reverse-mode gradients go through every step
by autograd, to any order; ``remat=True`` recomputes each step in the
backward pass (``torch.utils.checkpoint``) instead of keeping its stages,
except inside a functorch transform.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from xitorch_tpu_torch.utils.pytree import tree_flatten, tree_map

__all__ = ["rk4_ivp", "rk38_ivp", "fwd_euler_ivp", "mid_point_ivp", "explicit_rk"]


class _Tableau(NamedTuple):
    c: List[float]
    b: List[float]
    a: List[List[float]]


rk4_tableau = _Tableau(
    c=[0.0, 0.5, 0.5, 1.0],
    b=[1 / 6., 1 / 3., 1 / 3., 1 / 6.],
    a=[[0.0, 0.0, 0.0, 0.0],
       [0.5, 0.0, 0.0, 0.0],
       [0.0, 0.5, 0.0, 0.0],
       [0.0, 0.0, 1.0, 0.0]],
)
rk38_tableau = _Tableau(
    c=[0.0, 1 / 3, 2 / 3, 1.0],
    b=[1 / 8, 3 / 8, 3 / 8, 1 / 8],
    a=[[0.0, 0.0, 0.0, 0.0],
       [1 / 3, 0.0, 0.0, 0.0],
       [-1 / 3, 1.0, 0.0, 0.0],
       [1.0, -1.0, 1.0, 0.0]],
)
fwd_euler_tableau = _Tableau(c=[0.0], b=[1.0], a=[[0.0]])
mid_point_tableau = _Tableau(
    c=[0.0, 0.5],
    b=[0.0, 1.0],
    a=[[0.0, 0.0],
       [0.5, 0.0]],
)


def transformed(*tensors) -> bool:
    """True inside a functorch transform (vmap, grad, jacrev, ...)."""
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors)


def remat_step(step: Callable, remat: bool) -> Callable:
    """``step`` recomputed in the backward pass when ``remat`` is set and a
    graph is being built (outside one there is nothing to save).  Inside a
    functorch transform the step keeps its stages: ``torch.utils.checkpoint``
    does not run under ``vmap``."""
    if not remat:
        return step

    def run(*args):
        leaves = [a for a in tree_flatten(args)[0] if torch.is_tensor(a)]
        if torch.is_grad_enabled() and not transformed(*leaves):
            return checkpoint(step, *args, use_reentrant=False)
        return step(*args)

    return run


def explicit_rk(tableau: _Tableau, fcn: Callable, t: torch.Tensor, y0,
                params: Sequence = (), remat: bool = False, **unused):
    """Integrate dy/dt = fcn(t, y, *params) at times t (nt,), y0 a tensor
    or a dict/tuple/list of tensors.  Returns the same structure with a
    leading dim nt (yt[0] == y0)."""
    c, a, b = tableau.c, tableau.a, tableau.b
    s = len(c)

    def step(y, t0, t1):
        h = t1 - t0
        ks = []
        for j in range(s):
            if j == 0:
                k = fcn(t0, y, *params)
            else:
                ak = tree_map(lambda *kk: sum(a[j][m] * kk[m] for m in range(j)), *ks)
                yj = tree_map(lambda yy, aa: yy + h * aa, y, ak)
                k = fcn(t0 + c[j] * h, yj, *params)
            ks.append(k)
        ksum = tree_map(lambda *kk: sum(b[j] * kk[j] for j in range(s) if b[j] != 0), *ks)
        return tree_map(lambda yy, kk: yy + h * kk, y, ksum)

    step = remat_step(step, remat)
    ys = [y0]
    for k in range(t.shape[0] - 1):
        ys.append(step(ys[-1], t[k], t[k + 1]))
    return tree_map(lambda *v: torch.stack(v), *ys)


def rk4_ivp(fcn, t, y0, params=(), **kwargs):
    """Runge-Kutta steps of order 4 with fixed step size."""
    return explicit_rk(rk4_tableau, fcn, t, y0, params, **kwargs)


def rk38_ivp(fcn, t, y0, params=(), **kwargs):
    """Runge-Kutta 3/8-rule (order 4) with fixed step size."""
    return explicit_rk(rk38_tableau, fcn, t, y0, params, **kwargs)


def fwd_euler_ivp(fcn, t, y0, params=(), **kwargs):
    """Forward Euler with fixed step size."""
    return explicit_rk(fwd_euler_tableau, fcn, t, y0, params, **kwargs)


def mid_point_ivp(fcn, t, y0, params=(), **kwargs):
    """Explicit midpoint method (order 2) with fixed step size."""
    return explicit_rk(mid_point_tableau, fcn, t, y0, params, **kwargs)
