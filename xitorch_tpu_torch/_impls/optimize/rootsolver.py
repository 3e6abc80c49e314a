"""Quasi-Newton root solvers: newton, broyden1, broyden2, linearmixing
(counterpart of xitorch_tpu/_impls/optimize/rootsolver.py).

* The iteration is a Python loop that reads one stop flag a step (the
  reference's ``lax.while_loop``); it tracks the best iterate and returns
  it when the loop ends without converging.
* Broyden's rank-1 pairs live in a fixed-capacity ring buffer
  ``(max_rank, n)`` that overwrites the oldest pair on overflow; applying
  the inverse Jacobian is two skinny products over the active pairs.
* The Armijo line search backtracks with a quadratic, then cubic,
  interpolation; its step lengths are host scalars.
* Complex roots are solved on the doubled real vector ``[Re | Im]``.

These run without gradients; implicit differentiation lives in
``xitorch_tpu_torch.optimize.rootfinder``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["newton", "broyden1", "broyden2", "linearmixing", "TerminationCondition"]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v.abs() ** 2).sum())


class TerminationCondition:
    """All four criteria must hold: ``|dx| < x_tol``, ``|dx| < x_rtol |x|``,
    ``|f| < f_tol`` and ``|f| < f_rtol |f0|``."""

    def __init__(self, f_tol, f_rtol, f0_norm, x_tol, x_rtol):
        self.f_tol = 1e-6 if f_tol is None else f_tol
        self.f_rtol = math.inf if f_rtol is None else f_rtol
        self.x_tol = 1e-6 if x_tol is None else x_tol
        self.x_rtol = math.inf if x_rtol is None else x_rtol
        self.f0_norm = float(f0_norm)

    def check(self, x, y, dx) -> bool:
        xnorm, ynorm, dxnorm = (float(_norm(t)) for t in (x, y, dx))
        return (dxnorm < self.x_tol and dxnorm < self.x_rtol * xnorm
                and ynorm < self.f_tol and ynorm < self.f_rtol * self.f0_norm)


def _line_search_armijo(func, x, y, dx, c1=1e-4, amin=1e-2, max_niter=20):
    """Backtracking Armijo with quadratic-then-cubic interpolation on
    ``phi(s) = |func(x + s dx)|^2``.  Returns ``(s, xnew, ynew, |ynew|)``;
    when no step satisfies the condition, the full step."""
    f64 = np.float64
    phi0 = f64(float((y.abs() ** 2).sum()))
    derphi0 = -phi0

    def phi(s):
        return f64(float((func(x + float(s) * dx).abs() ** 2).sum()))

    def armijo(s, p):
        return bool(p <= phi0 + c1 * s * derphi0)

    with np.errstate(all="ignore"):
        alpha0 = f64(1.0)
        phi_a0 = phi(alpha0)
        if armijo(alpha0, phi_a0):
            s = alpha0
        else:
            # quadratic interpolation candidate
            alpha1 = -derphi0 * alpha0 ** 2 / 2.0 / (phi_a0 - phi0 - derphi0 * alpha0)
            phi_a1 = phi(alpha1)
            found, s = armijo(alpha1, phi_a1), alpha1
            a0, a1, p0, p1, k = alpha0, alpha1, phi_a0, phi_a1, 0
            while not found and a1 > amin and k < max_niter:
                factor = a0 ** 2 * a1 ** 2 * (a1 - a0)
                factor = f64(1e-30) if factor == 0 else factor
                aa = (a0 ** 2 * (p1 - phi0 - derphi0 * a1)
                      - a1 ** 2 * (p0 - phi0 - derphi0 * a0)) / factor
                bb = (-a0 ** 3 * (p1 - phi0 - derphi0 * a1)
                      + a1 ** 3 * (p0 - phi0 - derphi0 * a0)) / factor
                aa_safe = f64(1e-30) if aa == 0 else aa
                a2 = (-bb + np.sqrt(np.abs(bb ** 2 - 3 * aa * derphi0))) / (3.0 * aa_safe)
                # safeguard the cubic candidate before evaluating it
                a1_safe = f64(1e-30) if a1 == 0 else a1
                if (a1 - a2) > a1 / 2.0 or (1 - a2 / a1_safe) < 0.96:
                    a2 = a1 / 2.0
                p2 = phi(a2)
                if armijo(a2, p2):
                    found, s = True, a2
                a0, a1, p0, p1, k = a1, a2, p1, p2, k + 1
            if not found:
                s = f64(1.0)
    xnew = x + float(s) * dx
    ynew = func(xnew)
    return float(s), xnew, ynew, _norm(ynew)


def _lowrank_mv(alpha, cns, dns, count: int, v):
    # (alpha I + sum_i cns[i] dns[i]^T) v over the first `count` pairs, in
    # IEEE float32 (these are quasi-Newton update directions)
    if count == 0:
        return alpha * v
    return alpha * v + dot_hi(dot_hi(dns[:count], v), cns[:count])


def _lowrank_rmv(alpha, cns, dns, count: int, v):
    if count == 0:
        return alpha * v
    return alpha * v + dot_hi(dot_hi(cns[:count], v), dns[:count])


def _nonlin_solver(fcn, x0, params=(), *,
                   jac_variant: str,
                   alpha: Optional[float] = None,
                   uv0=None,
                   max_rank: Optional[int] = None,
                   # newton
                   solver_method: str = "exactsolve",
                   solver_kwargs: Optional[dict] = None,
                   # stopping criteria
                   maxiter=None, f_tol=None, f_rtol=None, x_tol=None, x_rtol=None,
                   # algorithm parameters
                   line_search=True,
                   custom_terminator=None,
                   # misc
                   verbose=False,
                   return_info=False,
                   **unused):
    """
    Keyword arguments
    -----------------
    maxiter: int or None
        Maximum number of iterations (default ``100*(numel+1)``).
    f_tol, f_rtol, x_tol, x_rtol: float or None
        Stopping tolerances, all of which must hold.
    line_search: bool or "armijo"
        Armijo backtracking on each step.
    alpha: float or None
        The initial inverse Jacobian is ``-alpha*I`` (broyden, linearmixing).
    max_rank: int or None
        Capacity of the rank-1 buffer; on overflow the oldest pair is
        overwritten.  The default keeps up to ``max(2*numel, 64)`` pairs
        (at most 4096); a smaller ring saves memory and time on a batch of
        systems that converges in fewer iterations.
    """
    xshape = x0.shape
    x_is_complex = x0.is_complex()

    def _ravel(x):
        if x_is_complex:
            return torch.cat((x.real.reshape(-1), x.imag.reshape(-1)))
        return x.reshape(-1)

    def _pack(xf):
        if x_is_complex:
            n2 = xf.shape[0] // 2
            return torch.complex(xf[:n2], xf[n2:]).reshape(xshape)
        return xf.reshape(xshape)

    def func(xf):
        return _ravel(fcn(_pack(xf), *params))

    x = _ravel(x0)
    n = x.shape[0]
    if maxiter is None:
        maxiter = 100 * (n + 1)
    if max_rank is None:
        max_rank = min(max(min(maxiter, max(2 * n, 64)), 8), 4096)
    if line_search is True:
        line_search = "armijo"

    y = func(x)
    y_norm = _norm(y)
    stop_cond = custom_terminator if custom_terminator is not None \
        else TerminationCondition(f_tol, f_rtol, y_norm, x_tol, x_rtol)

    if alpha is None:
        normy0 = float(y_norm)
        alpha_v = 0.5 * max(float(_norm(x)), 1.0) / normy0 if normy0 > 0 else 1.0
    else:
        alpha_v = float(alpha)

    use_broyden = jac_variant in ("broyden1", "broyden2")
    state = {"count": 0, "eta": 1e-3}
    if use_broyden:
        state["cns"] = torch.zeros((max_rank, n), dtype=x.dtype, device=x.device)
        state["dns"] = torch.zeros((max_rank, n), dtype=x.dtype, device=x.device)
        if uv0 is not None:
            if isinstance(uv0, str) and uv0 == "svd":
                # 1-rank SVD warm start of the inverse Jacobian
                uv0 = _get_svd_uv0(func, x)
            cn0, dn0 = uv0
            state["cns"][0] = cn0.reshape(-1) if cn0.shape != (n,) else cn0
            state["dns"][0] = dn0.reshape(-1) if dn0.shape != (n,) else dn0
            state["count"] = 1

    if jac_variant == "newton":
        from xitorch_tpu_torch.grad.jachess import jac as jac_op
        from xitorch_tpu_torch.linalg.solve import solve as linsolve
        skw = dict(solver_kwargs or {})
        # Eisenstat-Walker forcing: the inner Jacobian solve runs to the
        # adaptive RELATIVE tolerance ||J dx + f|| <= eta ||f||, loose far from
        # the root and tight near it (an absolute tolerance can exceed the
        # initial residual and make the inner solver return a zero step).
        # User-supplied tolerances win.
        use_ew = ("rtol" not in skw) and ("atol" not in skw) \
            and solver_method != "exactsolve"

        def gm_solve(x_cur, v):
            jl = jac_op(func, (x_cur,), idxs=0)
            if use_ew:
                return linsolve(jl, v[:, None], method=solver_method,
                                rtol=state["eta"], atol=1e-30, **skw)[:, 0]
            return linsolve(jl, v[:, None], method=solver_method, **skw)[:, 0]
    elif jac_variant == "linearmixing":
        la = -1.0 if alpha is None else alpha

        def gm_solve(x_cur, v):
            return -v * la
    else:
        def gm_solve(x_cur, v):
            return _lowrank_mv(-alpha_v, state["cns"], state["dns"],
                               min(state["count"], max_rank), v)

    def gm_update(dx, dy):
        if not use_broyden:
            return
        cns, dns, count = state["cns"], state["dns"], state["count"]
        nactive = min(count, max_rank)
        c = dx - _lowrank_mv(-alpha_v, cns, dns, nactive, dy)
        if jac_variant == "broyden1":
            v = _lowrank_rmv(-alpha_v, cns, dns, nactive, dx)
            denom = float((dy * v).sum())
        else:  # broyden2
            v = dy
            denom = float((dy * dy).sum())
        d = v / (denom if denom != 0 else 1e-30)
        # ring buffer: the sum of rank-1 terms is order-independent, so the
        # slot a pair lands in does not matter
        slot = count % max_rank
        cns[slot] = c
        dns[slot] = d
        state["count"] = count + 1

    ynorm = float(y_norm)
    best_x, best_ynorm = x, ynorm
    stop = ynorm == 0
    it = 0
    while not stop and it < maxiter:
        dx = -gm_solve(x, y)
        if line_search:
            _, xnew, ynew, ynorm_new = _line_search_armijo(func, x, y, dx)
        else:
            xnew = x + dx
            ynew = func(xnew)
            ynorm_new = _norm(ynew)
        ynorm_new = float(ynorm_new)
        if verbose:
            print("%6d: |dx|=%.3e, |f|=%.3e" % (it, float(_norm(dx)), ynorm_new))
        if ynorm_new < best_ynorm:
            best_x, best_ynorm = xnew, ynorm_new

        # Eisenstat-Walker eta adaptation
        gamma, eta_max, eta_threshold = 0.9, 0.9999, 0.1
        eta = state["eta"]
        eta_a = gamma * (ynorm_new / (ynorm if ynorm != 0 else 1.0)) ** 2
        gamma_eta2 = gamma * eta * eta
        state["eta"] = min(eta_max, eta_a) if gamma_eta2 < eta_threshold \
            else min(eta_max, max(eta_a, gamma_eta2))

        gm_update(xnew - x, ynew - y)
        stop = stop_cond.check(xnew, ynew, dx)
        x, y, ynorm = xnew, ynew, ynorm_new
        it += 1

    xfin = x if stop else best_x
    if return_info:
        dev = x.device
        info = {"converged": torch.tensor(float(stop), device=dev),
                "iterations": torch.tensor(float(it), device=dev),
                "best_fnorm": torch.tensor(best_ynorm, dtype=torch.float32, device=dev)}
        return _pack(xfin), info
    return _pack(xfin)


def newton(fcn, x0, params=(), *, solver_method: str = "exactsolve",
           solver_kwargs: Optional[dict] = None, **kwargs):
    """Newton's method ``x <- x - J(x)^{-1} f(x)`` with the exact Jacobian
    applied matrix-free."""
    return _nonlin_solver(fcn, x0, params, jac_variant="newton",
                          solver_method=solver_method,
                          solver_kwargs=solver_kwargs, **kwargs)


def broyden1(fcn, x0, params=(), *, alpha=None, uv0=None, max_rank=None, **kwargs):
    """Broyden's first (good) method with a fixed-capacity low-rank inverse
    Jacobian."""
    return _nonlin_solver(fcn, x0, params, jac_variant="broyden1",
                          alpha=alpha, uv0=uv0, max_rank=max_rank, **kwargs)


def broyden2(fcn, x0, params=(), *, alpha=None, uv0=None, max_rank=None, **kwargs):
    """Broyden's second (bad) method."""
    return _nonlin_solver(fcn, x0, params, jac_variant="broyden2",
                          alpha=alpha, uv0=uv0, max_rank=max_rank, **kwargs)


def linearmixing(fcn, x0, params=(), *, alpha=None, **kwargs):
    """Constant scalar inverse Jacobian ``-alpha*I``."""
    return _nonlin_solver(fcn, x0, params, jac_variant="linearmixing",
                          alpha=alpha, **kwargs)


def _get_svd_uv0(func, x0):
    """1-rank lowest-SVD warm start for the inverse Jacobian: J ~ u s v^H
    at x0 gives the pair (v / sqrt(s), u / sqrt(s)).  The Jacobian is
    matrix-free, so the port's svd takes its iterative (davidson) route."""
    from xitorch_tpu_torch.grad.jachess import jac as jac_op
    from xitorch_tpu_torch.linalg.symeig import svd

    fjac = jac_op(func, (x0,), idxs=0)
    u, s, vh = svd(fjac, k=1, mode="lowest", method="davidson", min_eps=1e-3)
    sinv_sqrt = 1.0 / torch.sqrt(torch.clamp(s, min=0.1))
    return sinv_sqrt * vh[..., 0, :], sinv_sqrt * u[..., :, 0]
