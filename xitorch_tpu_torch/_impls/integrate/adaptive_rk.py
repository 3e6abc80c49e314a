"""Adaptive Runge-Kutta (RK23 / RK45 Dormand-Prince) (counterpart of
xitorch_tpu/_impls/integrate/adaptive_rk.py).

The JAX stepper is one bounded ``lax.scan`` of ``max_steps`` trial slots,
each slot a single trial step masked to a no-op once the trajectory is
done.  Here the slot is the same masked tensor code (``torch.where``, no
host read inside it), run by a Python loop:

* under ``torch.func.vmap`` every trajectory keeps its own ``t``, ``h``,
  output index and accept flag, as under ``jax.vmap``, and the whole budget
  runs (a transform cannot stop on a value);
* outside any transform the loop stops once the trajectory is done, read
  after slots 1, 2, 4, ... up to ``_CHECK_EVERY`` and then every
  ``_CHECK_EVERY`` slots (a short run stops early, a long one reads the
  flag rarely): the slots it skips are no-ops, so the result and
  ``return_info`` equal those of the full budget;
* reverse-mode autograd goes through every slot, exact for the discrete
  solution; ``remat=True`` (the default, as in JAX) recomputes each trial
  step in the backward pass (``torch.utils.checkpoint``) instead of keeping
  its stages (not under a functorch transform, where checkpoint does not
  run).

Steps are clamped to land exactly on each output time, with the
previous-rejection factor clamp, and the error norm is taken over the whole
state, as in the JAX package (a batch in one call therefore shares its
step sizes; vmap gives each trajectory its own).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from xitorch_tpu_torch._impls.integrate.explicit_rk import remat_step, transformed
from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["rk23_adaptive", "rk45_adaptive"]

# the most slots between two reads of the done flag outside a functorch
# transform
_CHECK_EVERY = 32

_RK23 = dict(
    order=2,
    C=np.array([0, 1 / 2, 3 / 4]),
    A=np.array([
        [0, 0, 0],
        [1 / 2, 0, 0],
        [0, 3 / 4, 0]]),
    B=np.array([2 / 9, 1 / 3, 4 / 9]),
    E=np.array([5 / 72, -1 / 12, -1 / 9, 1 / 8]),
)

_RK45 = dict(
    order=4,
    C=np.array([0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1]),
    A=np.array([
        [0, 0, 0, 0, 0],
        [1 / 5, 0, 0, 0, 0],
        [3 / 40, 9 / 40, 0, 0, 0],
        [44 / 45, -56 / 15, 32 / 9, 0, 0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]]),
    B=np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]),
    E=np.array([-71 / 57600, 0, 71 / 16695, -71 / 1920, 17253 / 339200, -22 / 525,
                1 / 40]),
)


def _rk_adaptive(fcn: Callable, ts: torch.Tensor, y0: torch.Tensor,
                 params: Sequence, tbl: dict,
                 atol: float = 1e-8, rtol: float = 1e-5,
                 max_steps: int = 4096, remat: bool = True,
                 return_info: bool = False, **unused):
    """
    Keyword arguments
    -----------------
    atol, rtol: float
        Error tolerances for step-size control.
    max_steps: int
        Total trial-step budget for the whole trajectory.
    remat: bool
        Recompute each trial step in the backward pass instead of keeping
        its stages.
    return_info: bool
        Also return ``{"converged"`` (the budget covered all output times),
        ``"iterations"`` (accepted steps), ``"rejected"}`` as float32
        tensors.
    """
    yshape = y0.shape
    y0f = y0.reshape(-1)
    dtype, dev = y0f.dtype, y0f.device
    nt = ts.shape[0]

    # decreasing ts by time reflection
    sign = torch.where(ts[-1] >= ts[0], 1.0, -1.0).to(ts.dtype)
    ts_n = ts * sign

    def func(t, yf):
        return fcn(t * sign, yf.reshape(yshape), *params).reshape(-1) * sign

    n_stages = tbl["C"].shape[0]
    A = torch.as_tensor(tbl["A"], dtype=dtype, device=dev)
    B = torch.as_tensor(tbl["B"], dtype=dtype, device=dev)
    C = [float(c) for c in tbl["C"]]
    E = torch.as_tensor(tbl["E"], dtype=dtype, device=dev)
    err_exp = -1.0 / (tbl["order"] + 1.0)
    max_factor, min_factor, step_mult = 10.0, 0.2, 0.9

    def rk_step(t, y, f, h):
        ks = [f]
        for s in range(1, n_stages):
            # IEEE float32 for the stage combinations: they set the step error
            dy = dot_hi(A[s, :s], torch.stack(ks)) * h
            ks.append(func(t + C[s] * h, y + dy))
        ynew = y + h * dot_hi(B, torch.stack(ks))
        fnew = func(t + h, ynew)
        ks.append(fnew)
        # the step-size controller is a discrete control, not part of the
        # differentiable solution
        with torch.no_grad():
            err = dot_hi(E, torch.stack([k.detach() for k in ks])) * h.detach()
            errnorm = torch.sqrt(torch.sum(err * err))
        return ynew, fnew, errnorm

    rk_step = remat_step(rk_step, remat)

    f0 = func(ts_n[0], y0f)
    rows = torch.arange(nt, device=dev)[:, None]
    zero = torch.zeros((), dtype=ts.dtype, device=dev)
    t, y, f, h = ts_n[0], y0f, f0, ts_n[1] - ts_n[0]
    i = torch.zeros((), dtype=torch.int64, device=dev)
    prev_rejected = torch.zeros((), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    n_rej = torch.zeros((), dtype=torch.int64, device=dev)
    yt = y0f.expand(nt, y0f.shape[0])
    can_stop = not transformed(ts, y0f, f0)
    for slot in range(max_steps):
        done = i >= nt - 1
        idx = torch.clamp(i + 1, max=nt - 1)
        t_target = torch.index_select(ts_n, 0, idx.reshape(1)).reshape(())
        reach = t + h >= t_target
        hstep = torch.where(reach, t_target - t, h)
        # finished trajectories take zero-length steps: every evaluation of
        # fcn stays inside the integration window
        hstep = torch.where(done, zero, hstep)

        ynew, fnew, errnorm = rk_step(t, y, f, hstep)
        with torch.no_grad():
            ymax = torch.maximum(torch.linalg.vector_norm(y), torch.linalg.vector_norm(ynew))
            err = errnorm / (atol + ymax * rtol)
        accept = err < 1.0

        # step-size update
        err_safe = torch.where(err == 0, 1e-30, err)
        factor_acc = torch.clamp(step_mult * err_safe ** err_exp, max=max_factor)
        factor_acc = torch.where(err == 0, max_factor, factor_acc)
        factor_acc = torch.where(prev_rejected, torch.clamp(factor_acc, max=1.0), factor_acc)
        factor_rej = torch.clamp(step_mult * err_safe ** err_exp, min=min_factor)
        h_next = torch.where(accept, torch.where(reach, h, h * factor_acc), hstep * factor_rej)

        step_ok = accept & ~done
        reached = step_ok & reach
        prev_rejected = ~accept & ~done
        t = torch.where(step_ok, t + hstep, t)
        y = torch.where(step_ok, ynew, y)
        f = torch.where(step_ok, fnew, f)
        h = torch.where(done, h, h_next)
        yt = torch.where((rows == idx) & reached, ynew, yt)
        i = torch.where(reached, i + 1, i)
        n_acc = n_acc + step_ok
        n_rej = n_rej + prev_rejected
        ran = slot + 1
        if (can_stop and (ran % _CHECK_EVERY == 0 or ran & (ran - 1) == 0)
                and bool(i >= nt - 1)):
            break

    # a budget that ran out leaves the outputs past the last reached time
    # at the last state
    yt = torch.where(rows <= i, yt, y)
    yt = yt.reshape(nt, *yshape)
    if return_info:
        info = {"converged": (i >= nt - 1).to(torch.float32),
                "iterations": n_acc.to(torch.float32),
                "rejected": n_rej.to(torch.float32)}
        return yt, info
    return yt


def rk23_adaptive(fcn, ts, y0, params=(), **kwargs):
    """Adaptive Runge-Kutta of order 2(3) (Bogacki-Shampine)."""
    return _rk_adaptive(fcn, ts, y0, params, _RK23, **kwargs)


def rk45_adaptive(fcn, ts, y0, params=(), **kwargs):
    """Adaptive Runge-Kutta of order 4(5) (Dormand-Prince)."""
    return _rk_adaptive(fcn, ts, y0, params, _RK45, **kwargs)
