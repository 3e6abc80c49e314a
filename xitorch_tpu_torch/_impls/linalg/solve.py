"""Iterative and exact linear-solve methods (counterpart of
xitorch_tpu/_impls/linalg/solve.py).

* State is carried at shape ``(*B, na, ncols)``; a loop stops when every
  column of every batch element converges (global-all semantics, as in
  the JAX package) or at ``max_niter``.  PyTorch runs eagerly, so each
  loop is a Python loop whose stop test reads one scalar per iteration.
* The generalized problem ``AX - MXE = B`` is the broadcast operator
  ``X -> A.mm(X) - M.mm(X) * E[..., None, :]``.
* Non-convergence never raises: cg, bicgstab and cg_ir return the best
  iterate seen.
* ``gmres`` is a batched Givens-rotation GMRES: the residual falls out of
  the rotated right-hand side, which the loop reads once a step.
* The positive-definiteness probe is a power iteration from a fixed
  probe vector (``torch.Generator`` seeded 4219); the non-posdef fallback
  solves the normal equations ``A^H A x = A^H b``.

These functions run without gradients: :func:`xitorch_tpu_torch.linalg.solve`
wraps them in its implicit-gradient rule.
"""
from __future__ import annotations

from contextlib import ExitStack
from typing import Callable, Optional, Tuple

import torch

from xitorch_tpu_torch._core.linop import LinearOperator
from xitorch_tpu_torch.utils.bcast import get_bcasted_dims, normalize_bcast_dims
from xitorch_tpu_torch.utils.tensor import dot_hi, einsum_hi

__all__ = ["cg", "cg_ir", "minres", "bicgstab", "gmres", "exactsolve", "solve_ABE",
           "scipy_gmres", "broyden1_solve"]


# ------------------------------------------------------------------
# helpers
# ------------------------------------------------------------------

def _dot(r: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    # r, z: (*B, nr, nc) -> (*B, 1, nc); conjugate-linear in first arg
    return (r.conj() * z).sum(-2, keepdim=True)


def _safedenom(r: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(r == 0, eps, r)


def _colnorm(x: torch.Tensor) -> torch.Tensor:
    # (*B, nr, nc) -> (*B, 1, nc)
    return torch.sqrt((x.abs() ** 2).sum(-2, keepdim=True))


def get_batchdims(A: LinearOperator, B: torch.Tensor,
                  E: Optional[torch.Tensor], M: Optional[LinearOperator]):
    batchdims = [A.shape[:-2], B.shape[:-2]]
    if E is not None:
        batchdims.append(E.shape[:-1])
        if M is not None:
            batchdims.append(M.shape[:-2])
    return get_bcasted_dims(*batchdims)


def setup_linear_problem(A: LinearOperator, B: torch.Tensor,
                         E: Optional[torch.Tensor], M: Optional[LinearOperator],
                         posdef: Optional[bool],
                         need_hermit: bool
                         ) -> Tuple[Callable, Callable, torch.Tensor]:
    """Build (A_fcn, AT_fcn, B2) for the (possibly shifted, possibly
    normal-equation) problem.  B2 is B broadcast to the full output batch."""
    batchdims = get_batchdims(A, B, E, M)
    nr, ncols = A.shape[-1], B.shape[-1]
    B2 = B.expand(*batchdims, nr, ncols)

    if E is None:
        def A_fcn(x):
            return A.mm(x)

        def AT_fcn(x):
            return A.rmm(x)
    else:
        Eb = E[..., None, :]  # (*BE, 1, ncols)

        def A_fcn(x):
            Mx = M.mm(x) if M is not None else x
            return A.mm(x) - Mx * Eb

        def AT_fcn(x):
            MTx = M.rmm(x) if M is not None else x
            return A.rmm(x) - MTx * Eb.conj()

    if need_hermit:
        is_hermit = A.is_hermitian and (M is None or M.is_hermitian)
        if not is_hermit:
            posdef = False

    if posdef is None:
        # probe by power iterations: the largest eigenvalue, then the most
        # negative one of the operator shifted by it
        x0 = _probe_vector(batchdims, nr, ncols, B2.dtype, B2.device)
        largest = _get_largest_eival(A_fcn, x0)  # (*B, 1, nc)
        negeival = largest <= 0
        offset = torch.clamp(largest, min=0.0)
        mostneg = _get_largest_eival(lambda x: A_fcn(x) - offset * x, x0)
        posdef = bool(torch.all(torch.logical_or(-mostneg <= offset, negeival)))

    if posdef:
        return A_fcn, AT_fcn, B2

    # normal equations: A^H A x = A^H b (hermitian, posdef)
    def A_new(x):
        return AT_fcn(A_fcn(x))

    return A_new, A_new, AT_fcn(B2)


def _probe_vector(batchdims, nr, ncols, dtype, device):
    # deterministic pseudo-random probe
    gen = torch.Generator().manual_seed(4219)
    x0 = torch.randn((*batchdims, nr, ncols), generator=gen,
                     dtype=torch.float32).to(dtype=dtype, device=device)
    return x0 / _safedenom(_colnorm(x0), 1e-12)


def _get_largest_eival(A_fcn, x0, niter: int = 10):
    """Power-iteration estimate of the largest (signed) Rayleigh quotient."""
    x = x0
    for _ in range(niter - 1):
        y = A_fcn(x)
        x = y / _safedenom(_colnorm(y), 1e-12)
    y = A_fcn(x)
    # signed estimate via Rayleigh quotient so negative-definite detection works
    num = (x.conj() * y).sum(-2, keepdim=True).real
    den = (x.abs() ** 2).sum(-2, keepdim=True)
    return num / _safedenom(den, 1e-12)


def _setup_precond(precond) -> Callable:
    if precond is None:
        return lambda x: x
    if isinstance(precond, LinearOperator):
        return lambda x: precond.mm(x)
    if callable(precond):
        return precond
    raise TypeError("precond can only be a LinearOperator, callable, or None")


def _make_info(converged, iterations, resid, resid_rel):
    """Convergence info dict of float32 scalars.

    Library-wide honesty rule: ``resid`` is the MEASURED residual norm of
    the returned iterate, ``resid_rel = resid / stop``, and
    ``converged = resid_rel < 1.0`` at every call site.  ``stop`` is the
    method's documented tolerance: ``max(rtol*|B|, atol)`` for iterative
    methods, additionally floored at the working dtype's backward-error
    bound for direct methods (Thomas, exactsolve)."""
    def f32(v):
        return torch.as_tensor(v).detach().to(torch.float32)

    return {"converged": f32(converged), "iterations": f32(iterations),
            "resid": f32(resid), "resid_rel": f32(resid_rel)}


# ------------------------------------------------------------------
# Conjugate Gradient
# ------------------------------------------------------------------

def cg(A: LinearOperator, B: torch.Tensor,
       E: Optional[torch.Tensor] = None,
       M: Optional[LinearOperator] = None,
       posdef: Optional[bool] = None,
       precond=None,
       max_niter: Optional[int] = None,
       rtol: float = 1e-6,
       atol: float = 1e-8,
       eps: float = 1e-12,
       resid_calc_every: int = 10,
       track_best: bool = True,
       verbose: bool = False,
       return_info: bool = False,
       **unused) -> torch.Tensor:
    """Batched preconditioned conjugate gradient.

    posdef: bool or None — if None, determined by power iteration.
    precond: LinearOperator / callable / None.
    max_niter: default int(1.5 * na).
    rtol, atol: stopping tolerances on per-column residual norms vs |B|.
    eps: zero-denominator substitute.
    resid_calc_every: recompute the true residual with this cadence.
    track_best: keep (and return) the best iterate seen.
        ``track_best=False`` runs a leaner loop returning the final iterate.
    """
    nr = A.shape[-1]
    if max_niter is None:
        max_niter = int(1.5 * nr)

    precond_fcn = _setup_precond(precond)
    A_fcn, _, B2 = setup_linear_problem(A, B, E, M, posdef, need_hermit=True)

    if not track_best:
        return _cg_lean(A_fcn, precond_fcn, B2, rtol, atol, eps, max_niter,
                        resid_calc_every, return_info)

    B_norm = _colnorm(B2)
    stop_matrix = torch.clamp(rtol * B_norm, min=atol)

    xk = torch.zeros_like(B2)
    rk = B2 - A_fcn(xk)
    zk = precond_fcn(rk)
    pk = zk
    rkzk = _dot(rk, zk)
    best_x = xk
    best_resid = float(_colnorm(rk).max())

    k = 0
    resid_max_rel = float("inf")
    while k < max_niter and resid_max_rel >= 1.0:
        Apk = A_fcn(pk)
        alphak = rkzk / _safedenom(_dot(pk, Apk), eps)
        xk1 = xk + alphak * pk
        if resid_calc_every > 0 and (k + 1) % resid_calc_every == 0:
            rk1 = B2 - A_fcn(xk1)
        else:
            rk1 = rk - alphak * Apk

        resid_norm = _colnorm(rk1)
        max_resid = float(resid_norm.max())
        if verbose:
            print("%4d: |dy|=%.3e" % (k + 1, max_resid))
        if max_resid < best_resid:
            best_x = xk1
            best_resid = max_resid

        zk1 = precond_fcn(rk1)
        rkzk1 = _dot(rk1, zk1)
        betak = rkzk1 / _safedenom(rkzk, eps)
        pk = zk1 + betak * pk
        resid_max_rel = float((resid_norm / stop_matrix).max())
        k += 1
        xk, rk, zk, rkzk = xk1, rk1, zk1, rkzk1

    if return_info:
        # info must describe the iterate actually returned (the best one),
        # not the final loop iterate — one extra matvec buys consistency
        rc = _colnorm(B2 - A_fcn(best_x))
        rel = (rc / stop_matrix).max()
        return best_x, _make_info(rel < 1.0, k, rc.max(), rel)
    return best_x


def _cg_lean(A_fcn, precond_fcn, B2, rtol, atol, eps, max_niter,
             resid_calc_every, return_info=False):
    """Lean (preconditioned) CG: recurrence-based stopping on squared norms,
    no best-iterate tracking.  Reductions accumulate at >= f32."""
    dt = B2.dtype
    red = torch.promote_types(dt, torch.float32)

    def dot_red(a, b):
        return (a.conj() * b).to(red).sum(-2, keepdim=True)

    bnorm2 = dot_red(B2, B2).real
    stop2 = torch.clamp(rtol * rtol * bnorm2, min=atol * atol)

    x = torch.zeros_like(B2)
    r = B2
    z = precond_fcn(r)
    p = z
    rz = dot_red(r, z)
    rr = dot_red(r, r).real

    k = 0
    while k < max_niter and float((rr / stop2).max()) >= 1.0:
        Ap = A_fcn(p)
        alpha = (rz / _safedenom(dot_red(p, Ap), eps)).to(dt)
        x = x + alpha * p
        if resid_calc_every > 0 and (k + 1) % resid_calc_every == 0:
            r = B2 - A_fcn(x)
        else:
            r = r - alpha * Ap
        z = precond_fcn(r)
        rz_new = dot_red(r, z)
        beta = (rz_new / _safedenom(rz, eps)).to(dt)
        p = z + beta * p
        rz = rz_new
        rr = dot_red(r, r).real
        k += 1

    if return_info:
        rel2 = (rr / stop2).max()
        return x, _make_info(rel2 < 1.0, k, torch.sqrt(rr.max()), torch.sqrt(rel2))
    return x


# ------------------------------------------------------------------
# MINRES
# ------------------------------------------------------------------

def minres(A: LinearOperator, B: torch.Tensor,
           E: Optional[torch.Tensor] = None,
           M: Optional[LinearOperator] = None,
           max_niter: Optional[int] = None,
           rtol: float = 1e-6,
           atol: float = 1e-8,
           eps: float = 1e-12,
           verbose: bool = False,
           return_info: bool = False,
           **unused) -> torch.Tensor:
    """Batched MINRES (Paige-Saunders) for hermitian, possibly *indefinite*
    systems, such as the shifted systems ``A - lambda*I`` of symeig's
    implicit gradients.

    Lanczos three-term recurrence + Givens QR, one matvec per iteration,
    all state elementwise over the (*B, na, ncols) columns.  The residual
    norm of MINRES is monotonically non-increasing, so the final iterate
    is the best iterate.

    Keyword arguments: max_niter (default 1.5*na), rtol/atol (per-column
    stopping on the recurrence residual estimate), eps.
    """
    nr = A.shape[-1]
    if max_niter is None:
        max_niter = int(1.5 * nr)
    if not (A.is_hermitian and (M is None or M.is_hermitian)):
        raise RuntimeError(
            "minres requires a hermitian operator (and hermitian M); "
            "use bicgstab/gmres for non-hermitian systems")

    A_fcn, _, B2 = setup_linear_problem(A, B, E, M, True, need_hermit=True)

    beta1 = _colnorm(B2)
    stop_matrix = torch.clamp(rtol * beta1, min=atol)
    q = B2 / _safedenom(beta1, eps)
    zeros = torch.zeros_like(B2)
    one = torch.ones_like(beta1)
    zero = torch.zeros_like(beta1)

    x, q_old, beta = zeros, zeros, zero
    c1, c0, s1, s0 = one, one, zero, zero
    d1, d2, eta = zeros, zeros, beta1
    k = 0
    resid_rel = float("inf")
    # iterate to HALF the tolerance: the loop stops on the Lanczos
    # recurrence *estimate* of the residual, which rounding lets drift
    # above the measured residual
    while k < max_niter and resid_rel >= 0.5:
        p = A_fcn(q)
        # hermitian operator: the Lanczos diagonal is mathematically real
        alpha = _dot(q, p).real
        p = p - alpha * q - beta * q_old
        beta_new = _colnorm(p)
        q_new = p / _safedenom(beta_new, eps)

        # apply the two previous rotations to the new tridiagonal column
        delta = c1 * alpha - c0 * s1 * beta
        rho2 = s1 * alpha + c0 * c1 * beta
        rho3 = s0 * beta
        rho1 = torch.sqrt(delta * delta + beta_new * beta_new)
        c_new = delta / _safedenom(rho1, eps)
        s_new = beta_new / _safedenom(rho1, eps)

        d_new = (q - rho3 * d2 - rho2 * d1) / _safedenom(rho1, eps)
        x = x + (c_new * eta) * d_new
        eta = -s_new * eta

        resid = eta.abs()
        if verbose:
            print("%4d: |r|=%.3e" % (k + 1, float(resid.max())))
        resid_rel = float((resid / stop_matrix).max())
        k += 1
        q_old, q, beta = q, q_new, beta_new
        c0, c1, s0, s1 = c1, c_new, s1, s_new
        d2, d1 = d1, d_new

    if return_info:
        # measured residual, library-wide converged rule (see _make_info)
        true_resid = _colnorm(B2 - A_fcn(x))
        rel = (true_resid / stop_matrix).max()
        return x, _make_info(rel < 1.0, k, true_resid.max(), rel)
    return x


# ------------------------------------------------------------------
# BiCGSTAB
# ------------------------------------------------------------------

def bicgstab(A: LinearOperator, B: torch.Tensor,
             E: Optional[torch.Tensor] = None,
             M: Optional[LinearOperator] = None,
             posdef: Optional[bool] = None,
             precond_l=None,
             precond_r=None,
             max_niter: Optional[int] = None,
             rtol: float = 1e-6,
             atol: float = 1e-8,
             eps: float = 1e-12,
             resid_calc_every: int = 10,
             return_info: bool = False,
             **unused) -> torch.Tensor:
    """Batched stabilized biconjugate gradient (non-hermitian systems).

    posdef: as in :func:`cg` (``True`` skips the probe and the
        normal-equation fallback; bicgstab handles indefinite systems).
    precond_l, precond_r: left / right preconditioners (LinearOperator,
        callable or None).
    max_niter: default int(1.5 * na).
    resid_calc_every: recompute the true residual with this cadence.
    The best iterate seen is returned.
    """
    nr = A.shape[-1]
    if max_niter is None:
        max_niter = int(1.5 * nr)

    pl = _setup_precond(precond_l)
    pr = _setup_precond(precond_r)
    A_fcn, _, B2 = setup_linear_problem(A, B, E, M, posdef, need_hermit=False)

    stop_matrix = torch.clamp(rtol * _colnorm(B2), min=atol)

    xk = torch.zeros_like(B2)
    rk = B2 - A_fcn(xk)
    r0hat = rk
    rho_k = _dot(r0hat, rk)
    omega_k = torch.ones_like(rho_k)
    alpha = torch.ones_like(rho_k)
    vk = torch.zeros_like(rk)
    pk = torch.zeros_like(rk)
    best_x = xk
    best_resid = float(_colnorm(rk).max())

    k = 0
    resid_max_rel = float("inf")
    while k < max_niter and resid_max_rel >= 1.0:
        rho_new = _dot(r0hat, rk)
        beta = rho_new / _safedenom(rho_k, eps) * (alpha / _safedenom(omega_k, eps))
        pk = rk + beta * (pk - omega_k * vk)
        y = pr(pk)
        vk = A_fcn(y)
        alpha = rho_new / _safedenom(_dot(r0hat, vk), eps)
        h = xk + alpha * y
        s = rk - alpha * vk
        z = pr(s)
        t = A_fcn(z)
        Kt = pl(t)
        omega_k = _dot(Kt, pl(s)) / _safedenom(_dot(Kt, Kt), eps)
        xk = h + omega_k * z
        if resid_calc_every > 0 and (k + 1) % resid_calc_every == 0:
            rk = B2 - A_fcn(xk)
        else:
            rk = s - omega_k * t

        resid_norm = _colnorm(rk)
        max_resid = float(resid_norm.max())
        if max_resid < best_resid:
            best_x = xk
            best_resid = max_resid
        resid_max_rel = float((resid_norm / stop_matrix).max())
        rho_k = rho_new
        k += 1

    if return_info:
        # describe the returned best iterate, not the final loop iterate
        rc = _colnorm(B2 - A_fcn(best_x))
        rel = (rc / stop_matrix).max()
        return best_x, _make_info(rel < 1.0, k, rc.max(), rel)
    return best_x


# ------------------------------------------------------------------
# GMRES (batched, Givens rotations)
# ------------------------------------------------------------------

def gmres(A: LinearOperator, B: torch.Tensor,
          E: Optional[torch.Tensor] = None,
          M: Optional[LinearOperator] = None,
          posdef: Optional[bool] = None,
          max_niter: Optional[int] = None,
          rtol: float = 1e-6,
          atol: float = 1e-8,
          eps: float = 1e-12,
          restart: Optional[int] = None,
          return_info: bool = False,
          **unused) -> torch.Tensor:
    """Batched GMRES with classical Gram-Schmidt (twice) and Givens rotations.

    The Arnoldi orthogonalisation is two batched contractions a step and
    the least-squares residual falls out of the Givens-rotated right-hand
    side.  Memory: the Krylov basis ``(k+1, *B, na, ncols)`` where
    ``k = restart`` (GMRES(k): cycles restart from the current iterate
    until ``max_niter`` total iterations) or ``max_niter`` when ``restart``
    is None (full GMRES; default ``min(na, 200)``).
    """
    nr = A.shape[-1]
    if max_niter is None:
        max_niter = min(int(nr), 200)

    # gmres handles general (non-hermitian, indefinite) systems directly, so
    # the normal-equation fallback is unnecessary: skip the posdef probe
    A_fcn, _, B2 = setup_linear_problem(A, B, E, M, True, need_hermit=False)

    stop_matrix = torch.clamp(rtol * _colnorm(B2), min=atol).squeeze(-2)  # (*B, nc)

    if restart is None or restart >= max_niter:
        x, iters, _ = _gmres_cycle(A_fcn, B2, torch.zeros_like(B2), max_niter,
                                   stop_matrix, eps)
    else:
        m = int(restart)
        ncycles = -(-max_niter // m)  # ceil
        x, iters, rel, c = torch.zeros_like(B2), 0, float("inf"), 0
        # same 0.5 estimate margin as the inner cycle (see _gmres_cycle)
        while c < ncycles and rel >= 0.5:
            x, k_fin, rel = _gmres_cycle(A_fcn, B2, x, m, stop_matrix, eps)
            iters += k_fin
            c += 1

    if return_info:
        # measured residual (one extra matvec): the Givens-rotated rhs
        # only gives a floating-point *estimate* of the residual norm
        rc = _colnorm(B2 - A_fcn(x))
        rel = (rc.squeeze(-2) / stop_matrix).max()
        return x, _make_info(rel < 1.0, iters, rc.max(), rel)
    return x


def _gmres_cycle(A_fcn, B2, x0, m: int, stop_matrix, eps: float):
    """One GMRES cycle of up to ``m`` Arnoldi steps from iterate ``x0``.
    Returns ``(x1, steps taken, resid_rel)``.

    The rotations of the steps so far are kept as their product ``Q``
    (``(*B, nc, m+1, m+1)``), so a new Hessenberg column is rotated by one
    contraction instead of one small operation per earlier step."""
    batch = B2.shape[:-2]
    nr, ncols = B2.shape[-2:]
    dtype, device = B2.dtype, B2.device

    r0 = B2 - A_fcn(x0)
    beta = _colnorm(r0)  # (*B, 1, nc)
    V = torch.zeros((m + 1, *batch, nr, ncols), dtype=dtype, device=device)
    V[0] = r0 / _safedenom(beta, eps)
    # Hessenberg in Givens-rotated (upper-triangular) form
    R = torch.zeros((*batch, ncols, m, m), dtype=dtype, device=device)
    g = torch.zeros((*batch, ncols, m + 1), dtype=dtype, device=device)
    g[..., 0] = beta.squeeze(-2).to(dtype)
    Q = torch.eye(m + 1, dtype=dtype, device=device).repeat(*batch, ncols, 1, 1)

    def arnoldi_dots(Vk, w):
        # Vk: (k+1, *B, nr, nc), w: (*B, nr, nc) -> h: (k+1, *B, nc); IEEE
        # float32: TF32 would lose the Krylov basis' orthogonality
        return einsum_hi("k...rc,...rc->k...c", Vk.conj(), w)

    k = 0
    resid_max_rel = float("inf")
    # iterate to HALF the tolerance (same margin as minres): the loop stops
    # on the Givens-rotated-rhs *estimate* of the residual, which
    # CGS2/rounding drift lets sit above the measured residual; the margin
    # keeps the post-hoc ``rel < 1.0`` info check from flagging a solve the
    # recurrence believed had just converged
    while k < m and resid_max_rel >= 0.5:
        w = A_fcn(V[k])
        Vk = V[:k + 1]
        # CGS2 orthogonalisation: two batched contraction sweeps
        h1 = arnoldi_dots(Vk, w)
        w = w - einsum_hi("k...c,k...rc->...rc", h1, Vk)
        h2 = arnoldi_dots(Vk, w)
        w = w - einsum_hi("k...c,k...rc->...rc", h2, Vk)
        hk1 = _colnorm(w)  # (*B, 1, nc), real
        V[k + 1] = w / _safedenom(hk1, eps)

        hcol = torch.cat([torch.movedim(h1 + h2, 0, -1),
                          hk1.squeeze(-2).to(dtype)[..., None]], dim=-1)  # (*B, nc, k+2)
        # the rotations of steps 0..k-1
        hcol = einsum_hi("...ij,...j->...i", Q[..., :k + 2, :k + 2], hcol)

        # new rotation zeroing the subdiagonal entry k+1
        f = hcol[..., k]        # (*B, nc), possibly complex
        gg = hcol[..., k + 1]   # (*B, nc), the magnitude hk1
        denom = _safedenom(torch.sqrt(f.abs() ** 2 + gg.abs() ** 2), eps)
        absf = _safedenom(f.abs(), eps)
        tiny_f = f.abs() < eps
        c_new = torch.where(tiny_f, 0.0, f.abs() / denom).to(dtype)
        s_new = torch.where(tiny_f, (gg / denom).to(dtype),
                            (f.conj() / absf) * (gg / denom))
        R[..., :k, k] = hcol[..., :k]
        R[..., k, k] = c_new.conj() * f + s_new.conj() * gg
        qk, qk1 = Q[..., k, :].clone(), Q[..., k + 1, :].clone()
        Q[..., k, :] = c_new.conj()[..., None] * qk + s_new.conj()[..., None] * qk1
        Q[..., k + 1, :] = -s_new[..., None] * qk + c_new[..., None] * qk1

        # update the rotated rhs
        gk = g[..., k].clone()
        g[..., k] = c_new.conj() * gk
        g[..., k + 1] = -s_new * gk

        # |g_{k+1}| is the GMRES residual norm of this step
        resid_max_rel = float((g[..., k + 1].abs() / stop_matrix).max())
        k += 1

    # back-substitute the (k x k) triangular system.  A column whose
    # right-hand side is zero breaks down at once with a zero diagonal and a
    # zero rotated rhs: a unit diagonal there gives y = 0, its solution (the
    # JAX package returns NaN for such a column)
    Rk = R[..., :k, :k]
    zero_diag = torch.diagonal(Rk, dim1=-2, dim2=-1) == 0
    y = torch.linalg.solve_triangular(Rk + torch.diag_embed(zero_diag.to(dtype)),
                                      g[..., :k, None], upper=True)[..., 0]  # (*B, nc, k)
    x = x0 + einsum_hi("k...rc,...ck->...rc", V[:k], y)
    return x, k, resid_max_rel


# ------------------------------------------------------------------
# exact (dense) solve
# ------------------------------------------------------------------

def exactsolve(A: LinearOperator, B: torch.Tensor,
               E: Optional[torch.Tensor] = None,
               M: Optional[LinearOperator] = None,
               return_info: bool = False,
               **unused) -> torch.Tensor:
    """Solve by materializing the operator.

    Differentiable through (PyTorch's dense linalg has native gradients),
    so the API layer uses it directly without the implicit rule.
    """
    if return_info:
        x = exactsolve(A, B, E, M)
        # measured residual under the library-wide rule (_make_info): a
        # dense LU on a (near-)singular pencil silently returns garbage
        with torch.no_grad():
            ax = A.mm(x)
            if E is not None:
                mx = M.mm(x) if M is not None else x
                ax = ax - mx * E[..., None, :]
            r = torch.linalg.norm(ax - B, dim=-2)
            bn = torch.linalg.norm(B, dim=-2)
            # normwise backward-error floor 100*eps*(||A||*||x|| + ||B||);
            # Frobenius bounds the pencil norm
            eps_d = torch.finfo(x.real.dtype).eps
            anorm = torch.linalg.norm(A.fullmatrix(), dim=(-2, -1))[..., None]
            if E is not None:
                mnorm = torch.linalg.norm(M.fullmatrix(), dim=(-2, -1))[..., None] \
                    if M is not None else 1.0
                anorm = anorm + E.abs() * mnorm
            xn = torch.linalg.norm(x, dim=-2)
            stop = torch.clamp(100 * eps_d * (anorm * xn + bn), min=1e-30)
            rel = (r / stop).max()
        return x, _make_info(rel < 1.0, 1.0, r.max(), rel)
    if E is None:
        return torch.linalg.solve(A.fullmatrix(), B)
    elif M is None:
        return solve_ABE(A.fullmatrix(), B, E)
    else:
        Mmatrix = M.fullmatrix()
        L = torch.linalg.cholesky(Mmatrix)
        tri = torch.linalg.solve_triangular
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
        LinvT = tri(L, eye, upper=False).mH
        AL = A.mm(LinvT)
        A2 = tri(L.expand(*AL.shape[:-2], *L.shape[-2:]), AL, upper=False)
        bb = get_bcasted_dims(L.shape[:-2], B.shape[:-2])
        B2 = tri(L.expand(*bb, *L.shape[-2:]), B.expand(*bb, *B.shape[-2:]),
                 upper=False)
        X2 = solve_ABE(A2, B2, E)
        return dot_hi(LinvT, X2)


def solve_ABE(A: torch.Tensor, B: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """Solve (A - E_c I) x_c = b_c for each column c.

    A: (*BA, na, na); B: (*BB, na, nc); E: (*BE, nc).  A singular shift
    is retried once with a diagonal jitter of 10*eps*max|A - E_c I|.
    """
    na = A.shape[-1]
    BA, BB, BE = normalize_bcast_dims(A.shape[:-2], B.shape[:-2], E.shape[:-1])
    batch = get_bcasted_dims(BA, BB, BE)
    nc = B.shape[-1]
    A_ = A.expand(*batch, na, na)
    B_ = B.expand(*batch, na, nc)
    E_ = E.reshape(*BE, nc).expand(*batch, nc)
    eye = torch.eye(na, dtype=A.dtype, device=A.device)
    eps = torch.finfo(A.dtype).eps

    cols = []
    for c in range(nc):
        AE = A_ - E_[..., c, None, None] * eye
        # b-independent singularity probe; the jitter is folded into the
        # matrix so the b -> x map stays linear
        ones = torch.ones((*AE.shape[:-1], 1), dtype=AE.dtype, device=AE.device)
        probe, info = torch.linalg.solve_ex(AE.detach(), ones)
        bad = ((info != 0) | ~torch.isfinite(probe).all(-1).all(-1))[..., None, None]
        dAE = 10 * eps * AE.abs().reshape(*AE.shape[:-2], -1).amax(-1)[..., None, None]
        AE_safe = AE + eye * torch.where(bad, dAE, torch.zeros_like(dAE))
        cols.append(torch.linalg.solve(AE_safe, B_[..., c:c + 1])[..., 0])
    return torch.stack(cols, dim=-1)


# ------------------------------------------------------------------
# bridges
# ------------------------------------------------------------------

def scipy_gmres(A: LinearOperator, B: torch.Tensor, E=None, M=None,
                min_eps: float = 1e-9, max_niter: Optional[int] = None,
                **unused) -> torch.Tensor:
    """SciPy gmres bridge: the operator is materialised and copied to the
    host with B, each column is solved there, and the result is copied
    back.  Kept for parity; prefer the native :func:`gmres`."""
    import numpy as np
    from scipy.sparse.linalg import gmres as _sp_gmres

    if E is not None or M is not None:
        raise RuntimeError("scipy_gmres can only do AX=B")
    if len(A.shape) != 2:
        raise RuntimeError("scipy_gmres requires an unbatched A")
    if max_niter is None:
        max_niter = 2 * A.shape[-1]
    Anp = A.fullmatrix().detach().cpu().numpy()
    Bnp = B.detach().cpu().numpy()
    Bb = Bnp.reshape(-1, *Bnp.shape[-2:])
    out = np.empty_like(Bb)
    for i in range(Bb.shape[0]):
        for c in range(Bb.shape[-1]):
            out[i, :, c], _ = _sp_gmres(Anp, Bb[i, :, c], rtol=min_eps, atol=1e-12,
                                        maxiter=max_niter)
    return torch.as_tensor(out.reshape(Bnp.shape), dtype=B.dtype, device=B.device)


def broyden1_solve(A: LinearOperator, B: torch.Tensor, E=None, M=None, **options):
    """Solve the linear system with the Broyden rootfinder on the residual
    ``A X - M X E - B`` of the flattened unknowns (one joint system over the
    batch and the columns).  ``options`` go to
    ``_impls.optimize.rootsolver.broyden1``."""
    from xitorch_tpu_torch._impls.optimize.rootsolver import broyden1

    nr, ncols = A.shape[-1], B.shape[-1]
    batchdims = get_batchdims(A, B, E, M)

    def fcn_rootfinder(xi):
        x = xi.reshape(*xi.shape[:-1], nr, ncols)
        y = A.mm(x) - B
        if E is not None:
            MX = M.mm(x) if M is not None else x
            y = y - MX * E[..., None, :]
        return y.reshape(*xi.shape[:-1], nr * ncols)

    x0 = torch.zeros((*batchdims, nr * ncols), dtype=A.dtype, device=B.device)
    x = broyden1(fcn_rootfinder, x0, **options)
    return x.reshape(*x.shape[:-1], nr, ncols)


# ------------------------------------------------------------------
# mixed-precision iterative refinement
# ------------------------------------------------------------------

def cg_ir(A: LinearOperator, B: torch.Tensor,
          E: Optional[torch.Tensor] = None,
          M: Optional[LinearOperator] = None,
          posdef: Optional[bool] = None,
          rtol: float = 1e-6,
          atol: float = 1e-8,
          inner_rtol: float = 5e-2,
          inner_max_niter: Optional[int] = None,
          max_refine: int = 20,
          low_dtype: torch.dtype = torch.bfloat16,
          return_info: bool = False,
          **options) -> torch.Tensor:
    """Mixed-precision iterative refinement around CG: the inner solves run
    with the operator's parameters cast to ``low_dtype``, while residuals
    are computed and accumulated at the working precision.  Converges to
    working-precision accuracy whenever kappa(A) * eps_low < 1.

    Keyword arguments: rtol/atol (outer stopping), inner_rtol (inner CG
    tolerance per refinement step), inner_max_niter, max_refine (outer
    iteration cap), low_dtype.
    """
    # cg_ir is only consistent when the OUTER residual operator is the plain
    # A - ME (hermitian, assumed posdef): a non-hermitian A (or an explicit
    # posdef=False) would switch the outer problem to the normal equations
    # while the inner correction still solves with plain A, an inconsistent
    # correction direction.  Fall back to cg in those cases.
    def full_precision_cg():
        return cg(A, B, E, M, posdef=posdef, rtol=rtol, atol=atol,
                  return_info=return_info, **options)

    is_hermit = A.is_hermitian and (M is None or M.is_hermitian)
    if max_refine <= 0 or B.is_complex() or not is_hermit or posdef is False:
        return full_precision_cg()
    work_dtype = B.dtype
    low = {id(p): p.detach().to(low_dtype)
           for op in (A, M) if op is not None
           for p in op.getlinopparams() if p.is_floating_point()}
    E_lo = E.to(low_dtype) if E is not None else None
    if inner_max_niter is None:
        inner_max_niter = min(int(A.shape[-1]), 100)

    def low_precision(fn):
        with ExitStack() as stack:
            stack.enter_context(A._replaced_params(low))
            if M is not None:
                stack.enter_context(M._replaced_params(low))
            return fn()

    # an operator whose matvec does not follow its parameters' type (a
    # closure over float32 tensors, say) cannot take the low type: one
    # product on a zero probe finds out, and such an operator gets the
    # full-precision cg
    probe = torch.zeros((*A.shape[:-2], A.shape[-1], B.shape[-1]), dtype=low_dtype,
                        device=B.device)
    try:
        if low_precision(lambda: A.mm(probe)).dtype != low_dtype:
            return full_precision_cg()
    except Exception:
        return full_precision_cg()

    A_fcn, _, B2 = setup_linear_problem(A, B, E, M, True, need_hermit=True)
    stop = torch.clamp(rtol * _colnorm(B2), min=atol)

    x = torch.zeros_like(B2)
    best_x, best_rmax, best_abs = x, float("inf"), float("inf")
    k = 0
    rmax = float("inf")
    while k < max_refine and rmax >= 1.0:
        r = B2 - A_fcn(x)
        # normalize the inner rhs per column so the low-precision solve's
        # tolerances stay meaningful as the residual shrinks (a fixed inner
        # atol would stall the refinement once ||r|| drops below it), and so
        # tiny residuals survive the cast
        rnorm = _colnorm(r).to(work_dtype)
        rhat = (r / _safedenom(rnorm, 1e-30)).to(low_dtype)
        dz = low_precision(lambda: cg(A, rhat, E_lo, M, posdef=True, rtol=inner_rtol,
                                      atol=1e-4, max_niter=inner_max_niter))
        x = x + dz.to(work_dtype) * rnorm
        r2c = _colnorm(B2 - A_fcn(x))
        rmax = float((r2c / stop).max())
        # best-iterate semantics: a stalled or diverging refinement must not
        # return a worse-than-best iterate
        if rmax < best_rmax:
            best_x, best_rmax, best_abs = x, rmax, float(r2c.max())
        k += 1

    if return_info:
        # the loop measures the TRUE residual of every iterate (not a
        # recurrence estimate), so the best iterate's numbers are at hand
        return best_x, _make_info(best_rmax < 1.0, k, best_abs, best_rmax)
    return best_x
