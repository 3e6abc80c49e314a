"""First-order minimizers (gd with momentum, adam) and L-BFGS (counterpart
of xitorch_tpu/_impls/optimize/minimizer.py).

The forward function returns ``(f, grad_f)`` pairs; gd and adam stop on any
of their criteria (OR), track the best-f iterate and return it when the
loop ends without converging; ``maxiter=0`` returns x0.  Each loop is a
Python loop that reads one stop flag a step.
"""
from __future__ import annotations

from typing import Callable

import torch

from xitorch_tpu_torch._impls.optimize.rootsolver import _norm

__all__ = ["gd", "adam", "lbfgs"]


def _info(stop, it, best_f, dev):
    return {"converged": torch.tensor(float(stop), device=dev),
            "iterations": torch.tensor(float(it), device=dev),
            "best_fnorm": torch.tensor(float(best_f), dtype=torch.float32, device=dev)}


def _minimize_loop(aux, update_fcn, fcn, x0, params,
                   maxiter, f_tol, f_rtol, x_tol, x_rtol, return_info=False):
    x, i, fprev = x0, 0, 0.0
    best_x, best_f = x0, float("inf")
    stop = maxiter == 0
    while not stop and i < maxiter:
        f, dfdx = fcn(x, *params)
        aux, v = update_fcn(aux, i, dfdx)
        xnew = x + v
        dxnorm, xnorm, f = float(_norm(xnew - x)), float(_norm(x)), float(f)
        df = abs(fprev - f)
        converge = (dxnorm < x_tol or dxnorm < x_rtol * xnorm
                    or df < f_tol or df < f_rtol * abs(f))
        stop = i > 0 and converge
        if f < best_f:
            best_x, best_f = x, f
        x, fprev, i = xnew, f, i + 1
    x_final = x if stop else best_x
    if return_info:
        return x_final, _info(stop, i, best_f, x0.device)
    return x_final


def gd(fcn: Callable, x0: torch.Tensor, params=(), *,
       step: float = 1e-3,
       gamma: float = 0.9,
       maxiter: int = 1000,
       f_tol: float = 0.0, f_rtol: float = 1e-8,
       x_tol: float = 0.0, x_rtol: float = 1e-8,
       verbose=False, **unused):
    """Gradient descent with momentum: ``v <- gamma*v - step*grad;
    x <- x + v``."""
    def update(v, i, dfdx):
        v = gamma * v - step * dfdx
        return v, v

    return _minimize_loop(torch.zeros_like(x0), update, fcn, x0, params,
                          maxiter, f_tol, f_rtol, x_tol, x_rtol,
                          return_info=unused.get("return_info", False))


def lbfgs(fcn: Callable, x0: torch.Tensor, params=(), *,
          history: int = 10,
          maxiter: int = 500,
          max_ls: int = 20,
          c1: float = 1e-4,
          tau: float = 0.5,
          gtol: float = 1e-9,
          f_tol: float = 0.0, f_rtol: float = 1e-9,
          x_tol: float = 0.0, x_rtol: float = 1e-9,
          verbose=False, **unused):
    """Limited-memory BFGS with Armijo backtracking.

    A ring of the last ``history`` (s, y) pairs feeds the two-loop
    recursion; pairs with ``s.y <= 1e-10 |s||y|`` are skipped.  Stops when
    the gradient norm is below ``gtol`` or on the gd/adam-style f/x
    criteria; without convergence it returns the best-f iterate."""
    m = int(history)
    x0f = x0.reshape(-1)
    dtype, dev = x0.dtype, x0.device
    n = x0f.shape[0]

    def eval_fg(x):
        f, g = fcn(x.reshape(x0.shape), *params)
        return float(f), g.reshape(-1)

    def _dot(a, b):
        return float((a * b).sum())

    S = torch.zeros((m, n), dtype=dtype, device=dev)
    Y = torch.zeros_like(S)
    rho = [0.0] * m
    head = cnt = 0

    def direction(g):
        # two-loop recursion; the k-th most recent pair sits at (head-1-k) % m
        q = g.clone()
        alphas = [0.0] * m
        for k in range(cnt):
            idx = (head - 1 - k) % m
            alphas[idx] = rho[idx] * _dot(S[idx], q)
            q = q - alphas[idx] * Y[idx]
        newest = (head - 1) % m
        gamma = 1.0 / max(rho[newest] * _dot(Y[newest], Y[newest]), 1e-30) if cnt else 1.0
        r = gamma * q
        for k in reversed(range(cnt)):           # oldest -> newest
            idx = (head - 1 - k) % m
            b = rho[idx] * _dot(Y[idx], r)
            r = r + S[idx] * (alphas[idx] - b)
        return -r

    x = x0f
    f, g = eval_fg(x)
    best_x, best_f = x, f
    i, stop = 0, maxiter == 0
    while not stop and i < maxiter:
        d = direction(g)
        gd_ = _dot(g, d)
        if not gd_ < 0:
            # safeguard: steepest descent on a non-descent direction
            d, gd_ = -g, -_dot(g, g)
        # Armijo backtracking; the first iteration opens at a |g|-scaled step
        gnorm = _dot(g, g) ** 0.5
        t = min(1.0, 1.0 / max(gnorm, 1e-30)) if i == 0 else 1.0
        # the accepted point is one that was evaluated, also when max_ls
        # runs out (the curvature pair must use a gradient at that point)
        f_new, g_new = eval_fg(x + t * d)
        j = 1
        while not f_new <= f + c1 * t * gd_ and j < max_ls:
            t = t * tau
            f_new, g_new = eval_fg(x + t * d)
            j += 1
        x_new = x + t * d

        s = x_new - x
        yv = g_new - g
        sy = _dot(s, yv)
        if sy > 1e-10 * (_dot(s, s) * _dot(yv, yv) + 1e-300) ** 0.5:
            S[head % m] = s
            Y[head % m] = yv
            rho[head % m] = 1.0 / sy
            head = (head + 1) % m
            cnt = min(cnt + 1, m)

        dxnorm = float(_norm(s))
        df = abs(f - f_new)
        stop = (dxnorm < x_tol or dxnorm < x_rtol * float(_norm(x))
                or df < f_tol or df < f_rtol * abs(f_new)
                or _dot(g_new, g_new) ** 0.5 < gtol)
        if f_new < best_f:
            best_x, best_f = x_new, f_new
        x, f, g, i = x_new, f_new, g_new, i + 1
    x_final = (x if stop else best_x).reshape(x0.shape)
    if unused.get("return_info", False):
        return x_final, _info(stop, i, best_f, dev)
    return x_final


def adam(fcn: Callable, x0: torch.Tensor, params=(), *,
         step: float = 1e-3,
         beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
         maxiter: int = 1000,
         f_tol: float = 0.0, f_rtol: float = 1e-8,
         x_tol: float = 0.0, x_rtol: float = 1e-8,
         verbose=False, **unused):
    """Adam (Kingma & Ba 2015) on the (f, grad) pair."""
    def update(aux, i, dfdx):
        m, v = aux
        m = beta1 * m + (1 - beta1) * dfdx
        v = beta2 * v + (1 - beta2) * dfdx ** 2
        t = i + 1
        mhat = m / (1 - beta1 ** t)
        vhat = v / (1 - beta2 ** t)
        return (m, v), -step * mhat / (vhat ** 0.5 + eps)

    return _minimize_loop((torch.zeros_like(x0), torch.zeros_like(x0)), update, fcn, x0,
                          params, maxiter, f_tol, f_rtol, x_tol, x_rtol,
                          return_info=unused.get("return_info", False))
