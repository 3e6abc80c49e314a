"""Iterative and exact linear-solve methods (counterpart of
xitorch_tpu/_impls/linalg/solve.py).

* State is carried at shape ``(*B, na, ncols)``; a loop stops when every
  column of every batch element converges (global-all semantics, as in
  the JAX package) or at ``max_niter``.  PyTorch runs eagerly, so each
  loop is a Python loop whose stop test reads one scalar per iteration.
* The generalized problem ``AX - MXE = B`` is the broadcast operator
  ``X -> A.mm(X) - M.mm(X) * E[..., None, :]``.
* Non-convergence never raises: cg returns the best iterate seen.
* The positive-definiteness probe is a power iteration from a fixed
  probe vector (``torch.Generator`` seeded 4219); the non-posdef fallback
  solves the normal equations ``A^H A x = A^H b``.

These functions run without gradients: :func:`xitorch_tpu_torch.linalg.solve`
wraps them in its implicit-gradient rule.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from xitorch_tpu_torch._core.linop import LinearOperator
from xitorch_tpu_torch.utils.bcast import get_bcasted_dims, normalize_bcast_dims
from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["cg", "minres", "exactsolve", "solve_ABE"]


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
