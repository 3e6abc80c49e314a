"""Continuous (backsolve) adjoint for solve_ivp (counterpart of
xitorch_tpu/integrate/_adjoint.py).

Integrates the augmented state [y, a = dL/dy, dL/dtheta] backwards in
time, segment by segment between output times, re-injecting the incoming
cotangent at each output time, with the SAME solver.  Memory O(state)
instead of O(steps), but the gradients are those of the continuous
problem (approximate for the discretised forward solution) and, as the JAX
``custom_vjp`` it ports, first order only: differentiating its gradient
again raises; use the default adjoint for a gradient of a gradient.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from xitorch_tpu_torch.utils.pytree import ravel_pytree

__all__ = ["backsolve_ivp"]


def backsolve_ivp(solver: Callable, fcn: Callable, ts: torch.Tensor,
                  y0: torch.Tensor, dynparams, **options) -> torch.Tensor:
    """Run ``solver(fcn, ts, y0, params)`` forward; backward by the
    continuous adjoint.  ``y0`` must be a flat tensor, ``dynparams`` a
    sequence of tensors."""
    return _Backsolve.apply(solver, fcn, options, ts, y0, *dynparams)


class _Backsolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, solver, fcn, options, ts, y0, *dynparams):
        yt = solver(fcn, ts, y0, tuple(dynparams), **options)
        ctx.solver, ctx.fcn, ctx.options = solver, fcn, options
        ctx.save_for_backward(ts, yt, *dynparams)
        return yt

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_yt):
        ts, yt, *dynparams = ctx.saved_tensors
        solver, fcn, options = ctx.solver, ctx.fcn, ctx.options
        nt = ts.shape[0]
        ny = yt.shape[-1]
        pflat, punravel = ravel_pytree(list(dynparams)) if dynparams else (
            yt.new_zeros(0), lambda v: [])
        npar = pflat.shape[0]

        # augmented dynamics on s = [y (ny), a (ny), gp (npar)], integrated
        # backwards through the solver's decreasing-ts support
        def aug(t, s):
            with torch.enable_grad():
                y = s[:ny].detach().requires_grad_()
                pf = pflat.detach().requires_grad_()
                f = fcn(t, y, *punravel(pf))
                aty, atp = torch.autograd.grad(f, (y, pf), s[ny:2 * ny], allow_unused=True)
            aty = torch.zeros_like(y) if aty is None else aty
            atp = torch.zeros_like(pf) if atp is None else atp
            return torch.cat([f.detach(), -aty, -atp])

        a = torch.zeros((ny,), dtype=yt.dtype, device=yt.device)
        gp = torch.zeros((npar,), dtype=yt.dtype, device=yt.device)
        for i in range(nt - 2, -1, -1):
            # integrate from ts[i+1] down to ts[i]
            a = a + grad_yt[i + 1]
            s0 = torch.cat([yt[i + 1], a, gp])
            s1 = solver(aug, torch.stack([ts[i + 1], ts[i]]), s0, (), **options)[-1]
            a, gp = s1[ny:2 * ny], s1[2 * ny:]
        grad_y0 = a + grad_yt[0]

        # ts gradients: dL/dts[i] = <grad_yt[i], f(ts[i], y_i)> for i > 0
        # (sampling-time sensitivity); for ts[0], shifting the start with
        # the same y0 moves the whole trajectory by -Phi(t_i, t0) f(t0, y0),
        # so dL/dts[0] = -<a(t0), f(t0, y0)> with a(t0) the fully
        # back-integrated adjoint before the grad_yt[0] injection
        grad_ts = torch.stack([torch.dot(fcn(ts[i], yt[i], *dynparams).reshape(-1),
                                         grad_yt[i].reshape(-1)) for i in range(nt)])
        f_t0 = fcn(ts[0], yt[0], *dynparams).reshape(-1)
        grad_ts[0] = -torch.dot(f_t0, a.reshape(-1))
        return (None, None, None, grad_ts, grad_y0, *punravel(gp))
