"""Anderson acceleration for fixed-point problems (counterpart of
xitorch_tpu/_impls/optimize/equilibrium.py).

Natively batched (leading batch dims preserved), with ``msize``-slot
history buffers and a Python loop that reads one stop flag a step.  The
regularised Gram system keeps a static ``(msize, msize)`` shape (inactive
history slots get identity rows), solved by the SPD reduction of the
bordered least-squares system with an unrolled pivot-free elimination, as
in the reference.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from xitorch_tpu_torch._impls.optimize.rootsolver import TerminationCondition, _norm
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["anderson_acc"]


def anderson_acc(fcn: Callable, x0: torch.Tensor, params=(),
                 feat_ndims: int = 1,
                 msize: int = 5,
                 beta: float = 1.0,
                 lmbda: float = 1e-4,
                 maxiter=None, f_tol=None, f_rtol=None, x_tol=None, x_rtol=None,
                 custom_terminator=None,
                 verbose: bool = False,
                 return_info: bool = False,
                 **unused) -> torch.Tensor:
    """Solve ``x = fcn(x, *params)`` by Anderson acceleration (Walker & Ni).

    feat_ndims: number of trailing feature dims (the rest are batch).
    msize: history length; beta: damping; lmbda: Gram regulariser.
    f_* / x_*: stopping tolerances on ``f - x`` and the step.
    """
    nd = x0.dim()
    featshape = x0.shape[nd - feat_ndims:]
    batch_shape = x0.shape[:nd - feat_ndims]
    feat_size = int(math.prod(featshape))
    dtype, dev = x0.dtype, x0.device
    if maxiter is None:
        maxiter = 100 * (feat_size + 1)

    def _fcn(xn):
        return fcn(xn.reshape(*batch_shape, *featshape), *params).reshape(
            *batch_shape, feat_size)

    xn = x0.reshape(*batch_shape, feat_size)
    fn = _fcn(xn)
    xcol = torch.zeros((*batch_shape, msize, feat_size), dtype=dtype, device=dev)
    fcol = torch.zeros_like(xcol)
    xcol[..., 0, :] = xn
    fcol[..., 0, :] = fn
    xn1 = fn
    fn1 = _fcn(xn1)
    xcol[..., 1, :] = xn1
    fcol[..., 1, :] = fn1

    devnorm = _norm(fn1 - xn1)
    stop_cond = custom_terminator if custom_terminator is not None \
        else TerminationCondition(f_tol, f_rtol, devnorm, x_tol, x_rtol)
    eye_m = torch.eye(msize, dtype=dtype, device=dev)
    iot_m = torch.arange(msize, device=dev)

    def _solve_spd_small(A, b):
        """The batched (m, m) SPD system by unrolled pivot-free Gaussian
        elimination: SPD plus the lmbda ridge keeps every pivot at least
        min(lmbda, 1)."""
        Ab = torch.cat([A, b[..., None]], dim=-1)          # (*B, m, m+1)
        for kk in range(msize):
            piv = Ab[..., kk:kk + 1, :] / Ab[..., kk:kk + 1, kk:kk + 1]
            mask = (iot_m > kk).to(dtype)[:, None]
            Ab = Ab - mask * Ab[..., :, kk:kk + 1] * piv
        x = torch.zeros_like(b)
        for kk in reversed(range(msize)):
            dot = (Ab[..., kk, :msize] * x).sum(-1)
            x[..., kk] = (Ab[..., kk, msize] - dot) / Ab[..., kk, kk]
        return x

    def step(k, xcol, fcol):
        active = (iot_m < min(k, msize)).to(dtype)           # (m,)
        g = (fcol - xcol) * active[:, None]                   # (*B, m, feat)
        gram = einsum_hi("...nf,...mf->...nm", g, g)
        # constrained least squares min ||G alpha|| s.t. sum(alpha) = 1:
        # alpha = z / sum(z) with (G + lmbda I) z = 1_active (the SPD
        # reduction of the bordered KKT system); inactive slots get identity
        # rows and a zero right-hand side, so z is exactly zero there
        act2 = active[:, None] * active[None, :]
        greg = gram * act2 + lmbda * eye_m * act2 + eye_m * (1 - active)
        z = _solve_spd_small(greg, active.expand(*batch_shape, msize).clone())
        denom = z.sum(-1, keepdim=True)
        # sum(z) = 1^T (G + lmbda I)^-1 1 > 0 (SPD); this guards underflow only
        denom = torch.where(denom.abs() < torch.finfo(dtype).tiny * 16,
                            torch.ones_like(denom), denom)
        alpha = (z / denom) * active
        xnew = (einsum_hi("...n,...nf->...f", alpha, fcol) * beta
                + einsum_hi("...n,...nf->...f", alpha, xcol) * (1 - beta))
        fnew = _fcn(xnew)
        slot = k % msize
        xcol[..., slot, :] = xnew
        fcol[..., slot, :] = fnew
        return xnew, fnew

    k, stop = 2, float(devnorm) == 0
    best_x, best_dev = xn1, float(devnorm)
    while not stop and k < maxiter:
        xprev = xn1
        xn1, fnew = step(k, xcol, fcol)
        stop = stop_cond.check(xn1, fnew - xn1, xn1 - xprev)
        # best-iterate tracking: aggressive mixing can diverge after passing
        # near the fixed point, so the best deviation seen is returned
        dev_k = float(_norm(fnew - xn1))
        if dev_k < best_dev:
            best_x, best_dev = xn1, dev_k
        if verbose:
            print("%6d: |f - x|=%.3e" % (k, dev_k))
        k += 1
    out = best_x.reshape(*batch_shape, *featshape)
    if return_info:
        info = {"converged": torch.tensor(float(stop), device=dev),
                "iterations": torch.tensor(float(k), device=dev),
                "best_fnorm": torch.tensor(best_dev, dtype=torch.float32, device=dev)}
        return out, info
    return out
