"""Fixed-step implicit (A-stable) integrators for stiff ODEs (counterpart of
xitorch_tpu/_impls/integrate/implicit_rk.py).

* ``bwd_euler_ivp``   — backward Euler (order 1, L-stable)
* ``trapezoidal_ivp`` — trapezoidal / Crank-Nicolson (order 2, A-stable)
* ``sdirk2_ivp``      — two-stage SDIRK (order 2, L-stable)

Each step solves its implicit equation with a fixed number of unrolled
Newton iterations: the Jacobian of the flattened state by
``torch.func.jacfwd`` and a dense ``torch.linalg.solve`` (the JAX package
uses ``jax.jacfwd`` and ``jnp.linalg.solve``; no kernel stands behind
either), appropriate for the moderate state sizes where stiff integrators
are used.  Reverse-mode gradients go through the unrolled Newton steps,
to second order.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.func import jacfwd

from xitorch_tpu_torch._impls.integrate.explicit_rk import remat_step
from xitorch_tpu_torch.utils.pytree import ravel_pytree

__all__ = ["bwd_euler_ivp", "trapezoidal_ivp", "sdirk2_ivp"]


def _newton_solve(f_flat, tt, const, coef, z, eye, newton_iters):
    """Solve z = const + coef * f(tt, z) by ``newton_iters`` unrolled
    Newton steps (dense jacfwd Jacobian of the flattened state)."""
    for _ in range(newton_iters):
        g = z - const - coef * f_flat(tt, z)
        J = eye - coef * jacfwd(lambda zz: f_flat(tt, zz))(z)
        z = z - torch.linalg.solve(J, g)
    return z


def _flat_problem(fcn, y0, params):
    y0_flat, unravel = ravel_pytree(y0)
    eye = torch.eye(y0_flat.shape[0], dtype=y0_flat.dtype, device=y0_flat.device)

    def f_flat(tt, zf):
        return ravel_pytree(fcn(tt, unravel(zf), *params))[0]

    return y0_flat, unravel, eye, f_flat


def _run(step, t, y0_flat, unravel, remat):
    step = remat_step(step, remat)
    ys = [y0_flat]
    for k in range(t.shape[0] - 1):
        ys.append(step(ys[-1], t[k], t[k + 1]))
    return unravel(torch.stack(ys))


def _implicit_theta(fcn: Callable, t: torch.Tensor, y0,
                    params: Sequence = (), *, theta: float,
                    newton_iters: int = 6, remat: bool = False, **unused):
    """theta-method: y1 = y0 + h*((1-theta) f(t0,y0) + theta f(t1,y1)).
    theta=1: backward Euler; theta=0.5: trapezoidal."""
    y0_flat, unravel, eye, f_flat = _flat_problem(fcn, y0, params)

    def step(yf, t0, t1):
        h = t1 - t0
        f0 = f_flat(t0, yf)
        const = yf + h * (1.0 - theta) * f0
        # predictor: explicit Euler
        return _newton_solve(f_flat, t1, const, h * theta, yf + h * f0, eye, newton_iters)

    return _run(step, t, y0_flat, unravel, remat)


def sdirk2_ivp(fcn: Callable, t: torch.Tensor, y0, params: Sequence = (),
               *, newton_iters: int = 6, remat: bool = False, **unused):
    """Two-stage SDIRK (Alexander 1977), gamma = 1 - 1/sqrt(2): both
    L-stable AND order 2.  Fixed steps; each stage is one unrolled Newton
    solve with the same diagonal coefficient gamma*h.

    Butcher tableau:  c = [gamma, 1];  a = [[gamma, 0],
    [1-gamma, gamma]];  b = [1-gamma, gamma]  (stiffly accurate:
    y1 = z2).
    """
    gamma = 1.0 - 0.5 ** 0.5
    y0_flat, unravel, eye, f_flat = _flat_problem(fcn, y0, params)

    def step(yf, t0, t1):
        h = t1 - t0
        f0 = f_flat(t0, yf)
        # stage 1: z1 = y + gamma*h*f(t0+gamma*h, z1)
        z1 = _newton_solve(f_flat, t0 + gamma * h, yf, gamma * h,
                           yf + gamma * h * f0, eye, newton_iters)
        k1 = f_flat(t0 + gamma * h, z1)
        # stage 2 (stiffly accurate): z2 = y + (1-gamma)*h*k1
        #                                  + gamma*h*f(t1, z2);  y1 = z2
        const = yf + (1.0 - gamma) * h * k1
        return _newton_solve(f_flat, t1, const, gamma * h,
                             const + gamma * h * k1, eye, newton_iters)

    return _run(step, t, y0_flat, unravel, remat)


def bwd_euler_ivp(fcn, t, y0, params=(), **kwargs):
    """Backward Euler (implicit, L-stable, order 1) with fixed step size.
    Options: newton_iters (default 6), remat."""
    kwargs.pop("theta", None)
    return _implicit_theta(fcn, t, y0, params, theta=1.0, **kwargs)


def trapezoidal_ivp(fcn, t, y0, params=(), **kwargs):
    """Trapezoidal / Crank-Nicolson (implicit, A-stable, order 2) with
    fixed step size.  Options: newton_iters (default 6), remat."""
    kwargs.pop("theta", None)
    return _implicit_theta(fcn, t, y0, params, theta=0.5, **kwargs)
