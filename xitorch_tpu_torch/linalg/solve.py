"""Differentiable linear solve ``AX = B`` / ``AX - MXE = B`` (counterpart of
xitorch_tpu/linalg/solve.py).

* forward: the selected method runs as a black box without gradients
  (gradients never flow through solver iterations);
* backward: a ``torch.autograd.Function`` solves the adjoint system
  ``A^H lam = g`` with this module's own public :func:`solve` (so the
  backward is differentiable again), and the gradients to E and to the
  parameters of A and M are ``torch.autograd.grad`` of
  ``-<lam, A X - M X E>`` at fixed X, created with a graph whenever
  gradients are enabled: first and second order both work.  A first-order
  backward of a float32 :class:`TridiagLowRankOperator` on CUDA tensors
  takes these gradients in closed form from one kernel launch instead
  (ops/tlr.py, :func:`_fused_param_grads`).
"""
from __future__ import annotations

import atexit
import warnings
from contextlib import ExitStack
from typing import Any, Callable, Mapping, Optional, Union

import torch

from xitorch_tpu_torch._core.kron import KronOperator, KronSumOperator
from xitorch_tpu_torch._core.linop import LinearOperator, MatrixLinearOperator
from xitorch_tpu_torch._core.structured import (
    BandedLowRankOperator, TridiagLowRankOperator,
)
from xitorch_tpu_torch._impls.linalg.solve import (
    _make_info, bicgstab, broyden1_solve, cg, cg_ir, exactsolve, get_batchdims,
    gmres, minres, scipy_gmres,
)
from xitorch_tpu_torch.debug.modes import is_debug_enabled
from xitorch_tpu_torch.debug.profiling import span, tracing
from xitorch_tpu_torch.ops.fused_cg import fits_fused_cg, fused_cg_dense
from xitorch_tpu_torch.ops.structured_cg import fits_structured_cg, structured_cg_solve
from xitorch_tpu_torch.ops.tlr import residual_verdict, tlr_param_grads, tlr_residual_check
from xitorch_tpu_torch.ops.tridiag import tridiag_matvec, tridiag_solve_kernel
from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning
from xitorch_tpu_torch.utils.misc import get_method

__all__ = ["solve", "flush_convergence_warnings"]

# eager checks of structured_cg solves on CUDA tensors whose verdict is
# still on its way to the host: (event, pinned host copy of (failed, max
# resid, max stop), method)
_PENDING: list = []
# methods whose eager check stops at the backward-error bound, not at rtol
_DIRECT_METHODS = ("exactsolve", "custom_exactsolve", "kron_direct")


def _fused_cg(A, B, E=None, M=None, rtol: float = 1e-6, atol: float = 1e-8,
              max_niter=None, **options):
    """Whole-iteration CG kernel for an explicit hermitian A
    (ops/fused_cg.py): one launch, no host round trip per step.  On CUDA
    tensors the kernel launches or the call raises: what the kernel does
    not take (a matrix-free or complex operator, an E/M shift, mixed dtypes,
    a shape outside ``fits_fused_cg``) is an error there, so that naming
    this method on the card never runs the Python-loop cg unnoticed.  On CPU
    tensors the kernel's plain PyTorch version runs, and what the kernel
    does not take goes to the matrix-free cg, as in the JAX package."""
    if (E is None and M is None and isinstance(A, MatrixLinearOperator)
            and A.is_hermitian and B.dtype == A.dtype
            and fits_fused_cg(A.shape[-1], B.shape[-1], A.dtype)):
        return fused_cg_dense(A.fullmatrix(), B, rtol=rtol, atol=atol,
                              max_niter=max_niter)
    if B.is_cuda:
        raise RuntimeError(
            "solve(method='fused_cg') on CUDA tensors takes an explicit hermitian "
            "float32 or float64 matrix operator (LinearOperator.m) of B's dtype, "
            "without E or M, inside the kernel's window (ops.fused_cg.fits_fused_cg); "
            "got %s, n=%d, ncols=%d, A %s, B %s, E %s, M %s.  Use method='cg' for "
            "this system." % (type(A).__name__, A.shape[-1], B.shape[-1], A.dtype,
                              B.dtype, "set" if E is not None else "None",
                              "set" if M is not None else "None"))
    return cg(A, B, E, M, rtol=rtol, atol=atol, max_niter=max_niter, **options)


def _structured_cg(A, B, E=None, M=None, rtol: float = 1e-6,
                   atol: float = 1e-8, max_niter=None,
                   return_info: bool = False, **options):
    """Fused solve for :class:`TridiagLowRankOperator` and
    :class:`BandedLowRankOperator`: the CG kernel keeps the whole CG state
    and the operator data of a system on chip, in registers or in shared
    memory (ops/structured_cg.py).  Pure tridiagonal operators (V is None) get a
    *direct* Thomas solve instead of CG.  Per-column diagonal shifts E
    (M=None) keep the structure — ``A - e_j I`` just shifts d.

    On CUDA tensors the kernels launch (or raise); on CPU tensors their
    plain PyTorch versions run.  Any other operator, float64, or an
    M-generalized shift goes to the matrix-free cg, as in the JAX
    package; so does a system no kernel design takes (fits_structured_cg)."""
    if not (M is None
            and isinstance(A, (TridiagLowRankOperator, BandedLowRankOperator))
            and A.dtype == torch.float32):
        return cg(A, B, E, M, rtol=rtol, atol=atol, max_niter=max_niter,
                  return_info=return_info, **options)

    n = A.shape[-1]
    if isinstance(A, TridiagLowRankOperator):
        cl, cu = A.full_couplings()
        bl = cl[..., None, :]
        bu = cu[..., None, :]
        offsets = (1,)
        pure_tridiag = A.V is None
    else:
        offsets = A.offsets
        if not offsets:  # diagonal-only: give it one zero band for layout
            bl = torch.zeros((*A.shape[:-2], 1, n), dtype=A.dtype, device=A.device)
            bu = bl
            offsets = (1,)
        else:
            bl, bu = A.full_bands()
        pure_tridiag = A.V is None and offsets == (1,)

    bT = B.transpose(-1, -2)  # (*B, ncols, n): columns into batch
    # per-column diagonal: columns are batch rows of bT, so E (*BE, ncols)
    # becomes a shift of d along that axis
    dcol = A.d[..., None, :]
    if E is not None:
        dcol = dcol - E[..., :, None]

    if pure_tridiag:
        dl = bl[..., 0, :][..., None, :]
        du = bu[..., 0, :][..., None, :]
        xT = tridiag_solve_kernel(dl, dcol, du, bT)
        x = xT.transpose(-1, -2)
        if return_info:
            # honest residual: the non-pivoting Thomas sweep silently
            # returns garbage on (near-)singular shifted systems; FORWARD
            # semantics (residual vs ||B||, floored only at
            # 100*eps*(||Ax||+||B||)), as in the JAX package
            ax = tridiag_matvec(dl, dcol, du, xT)
            r, stop = _residual_rule(ax, bT, rtol, atol, -1, torch.finfo(x.dtype).eps)
            rel = (r / stop).max()
            return x, _make_info(rel < 1.0, 1.0, r.max(), rel)
        return x

    rank = A.V.shape[-1] if A.V is not None else 1
    if not fits_structured_cg(n, rank, A.dtype, nb=len(offsets)):
        return cg(A, B, E, M, rtol=rtol, atol=atol, max_niter=max_niter,
                  return_info=return_info, **options)
    V = A.V if A.V is not None \
        else torch.zeros((*A.shape[:-2], n, 1), dtype=A.dtype, device=A.device)

    x, it, res = structured_cg_solve(
        dcol, bl[..., None, :, :], bu[..., None, :, :], V[..., None, :, :], bT,
        offsets=offsets, rtol=rtol, atol=atol, max_niter=max_niter)
    x = x.transpose(-1, -2)
    if return_info:
        # measured residual of the returned iterate (the kernel's ``res``
        # is the CG *recurrence* estimate, which rounding lets drift)
        ax = A.mm(x)
        if E is not None:
            ax = ax - x * E[..., None, :]
        rc, stop = _residual_rule(ax.transpose(-1, -2), bT, rtol, atol, -1)
        rel = (rc / stop).max()
        return x, _make_info(rel < 1.0, it.max(), rc.max(), rel)
    return x


def _residual_rule(ax, b, rtol, atol, dim, eps=None):
    """Each column's measured residual ``||ax - b||`` and its stop
    ``max(rtol ||b||, atol)``, norms along ``dim``; with ``eps`` (a direct
    method's, which has no iteration tolerance) the stop is raised to the
    backward-error floor ``100 eps (||ax|| + ||b||)``."""
    resid = torch.linalg.norm(ax - b, dim=dim)
    bnorm = torch.linalg.norm(b, dim=dim)
    stop = torch.clamp(rtol * bnorm, min=atol)
    if eps is not None:
        scale = torch.linalg.norm(ax, dim=dim) + bnorm
        stop = torch.maximum(stop, 100 * eps * scale)
    return resid, stop


def _kron_direct(A, B, E=None, M=None, return_info: bool = False,
                 refine: int = 1, **options):
    """Direct eigenbasis solve for hermitian Kronecker-structured
    operators (:class:`KronSumOperator` / :class:`KronOperator`):
    decompose the small factors (the Jacobi sweep kernel for CUDA float32
    factors inside its window), transform B into the product eigenbasis,
    divide by the combined eigenvalues (sums for the Kronecker sum,
    products for the Kronecker product, minus the per-column shifts E), and
    transform back: the classic "fast Poisson" route, O(n^3) in the factor
    sizes instead of O((n1*n2)^3) dense.  M-generalized problems and
    non-hermitian factors fall back to cg."""
    if not (M is None and isinstance(A, (KronOperator, KronSumOperator))
            and A.is_hermitian):
        return cg(A, B, E, M, return_info=return_info, **options)

    comb, Vs = A.combined_eigendecomposition()

    ncols = B.shape[-1]
    N = A.shape[-1]
    batch = comb.shape[:-len(A.dims)]
    denom = comb.reshape(*batch, N, 1)
    if E is not None:
        denom = denom - E[..., None, :]
    # singular pencils (an E shift hitting an eigenvalue sum exactly)
    # must not emit Inf/NaN: floor the denominator at eps * spectral
    # scale (keeping x bounded by ~1/eps) and remember which entries
    # saturated: info reports converged=0 for them, since the residual
    # of an ~1/eps-sized x is numerically meaningless
    eps_c = torch.finfo(comb.dtype).eps
    # per-batch scale: a global max would inflate the floor (and the
    # backward-error stop below) for small-scale batch elements
    anorm_b = comb.abs().reshape(*batch, N).amax(-1)  # (*batch,) spectral norm
    floor = eps_c * (anorm_b[..., None, None] + 1e-300)
    singular = denom.abs() < floor
    denom = torch.where(singular, torch.where(denom < 0, -floor, floor), denom)

    def eig_solve(rhs):
        # fold the rhs columns into the flattened vector (row-major:
        # they ride along as trailing "extra" in every axis transform)
        c = rhs.reshape(*rhs.shape[:-2], N * ncols)
        for i, V in enumerate(Vs):  # into the product eigenbasis
            c = A._apply_axis(c, V.mH, i, extra=ncols)
        c = c.reshape(*c.shape[:-1], N, ncols) / denom
        c = c.reshape(*c.shape[:-2], N * ncols)
        for i, V in enumerate(Vs):  # and back
            c = A._apply_axis(c, V, i, extra=ncols)
        return c.reshape(*c.shape[:-1], N, ncols)

    def residual(x):
        r = B - A.mm(x)
        if E is not None:
            r = r + x * E[..., None, :]
        return r

    x = eig_solve(B)
    # iterative refinement: the factor decompositions are the accuracy
    # bottleneck (float32 eigenvector error ~eps/gap on clustered spectra);
    # each pass costs two transform sweeps + one (cheap) structured matvec
    # and multiplies the residual by ~eps*kappa
    for _ in range(max(int(refine), 0)):
        x = x + eig_solve(residual(x))
    if return_info:
        # honest residual (one extra matvec): a singular pencil, an E
        # shift at an eigenvalue sum, must surface as converged=0
        r = torch.linalg.norm(residual(x), dim=-2)
        bn = torch.linalg.norm(B, dim=-2)
        # direct solve: converged follows the library-wide ``rel < 1.0``
        # rule (see _make_info) against the normwise backward-error floor
        # 100*eps*(||A||*||x|| + ||B||) of the working dtype (a direct
        # method has no iteration tolerance to compare against; ||A||*||x||,
        # not ||Ax||, is the standard scale, which matters exactly on
        # the ill-conditioned systems where x has large null-ish modes)
        eps_d = torch.finfo(r.dtype).eps
        anorm = anorm_b[..., None]  # (*batch, 1): exact per-batch
        # spectral norm for Kron (max |combined eigenvalue|)
        if E is not None:  # per-column pencil norm ||A - e_j||
            anorm = anorm + E.abs()
        xn = torch.linalg.norm(x, dim=-2)
        stop = torch.clamp(100 * eps_d * (bn + anorm * xn), min=1e-30)
        rel = (r / stop).max()
        ok = (rel < 1.0) & ~singular.any()
        return x, _make_info(ok, 1.0 + refine, r.max(), rel)
    return x


_SOLVE_METHODS = {
    "cg": cg,
    "cg_ir": cg_ir,
    "fused_cg": _fused_cg,
    "structured_cg": _structured_cg,
    "kron_direct": _kron_direct,
    "minres": minres,
    "bicgstab": bicgstab,
    "gmres": gmres,
    "exactsolve": exactsolve,
    "custom_exactsolve": exactsolve,
    "scipy_gmres": scipy_gmres,
    "broyden1": broyden1_solve,
}

# methods whose impl supports the (x, info) return convention
_INFO_METHODS = {"cg", "cg_ir", "minres", "bicgstab", "gmres", "exactsolve",
                 "custom_exactsolve", "structured_cg", "kron_direct"}


def solve(A: LinearOperator, B: torch.Tensor,
          E: Optional[torch.Tensor] = None,
          M: Optional[LinearOperator] = None,
          bck_options: Mapping[str, Any] = {},
          method: Union[str, Callable, None] = None,
          return_info: bool = False,
          **fwd_options) -> torch.Tensor:
    r"""Solve :math:`\mathbf{AX=B}` or :math:`\mathbf{AX-MXE=B}` (E diagonal,
    per column) for a (batched, matrix-free) LinearOperator.

    ``A (*BA, na, na)``, ``B (*BB, na, ncols)``, ``E (*BE, ncols)`` or None,
    ``M (*BM, na, na)`` hermitian or None.  ``method`` is a registry string
    ("cg", "cg_ir", "fused_cg", "structured_cg", "kron_direct", "minres",
    "bicgstab", "gmres", "exactsolve", "custom_exactsolve", "scipy_gmres",
    "broyden1") or a custom callable.  None picks
    structured_cg for structured operators (minres when they are E-shifted
    and not purely tridiagonal), kron_direct for hermitian Kron operators
    without M (matrix-free cg, minres or bicgstab otherwise), exactsolve for explicit or small
    operators, else cg for hermitian operators (minres when E-shifted) and
    bicgstab for non-hermitian ones.  "fused_cg" on CUDA tensors launches
    its kernel or raises (see :func:`_fused_cg`).

    Returns ``X (*BABEM, na, ncols)``; first and second order gradients flow
    to B, E, and the parameters of A and M by implicit differentiation.
    ``bck_options`` configures the adjoint solve of the backward pass
    (``"method"`` plus that method's options).

    With ``return_info=True``, returns ``(X, info)`` where ``info`` is a dict
    ``{"converged", "iterations", "resid", "resid_rel"}`` of float32
    scalars without gradients: ``resid`` is the measured residual norm of
    the returned iterate and ``converged = resid_rel < 1.0`` with
    ``resid_rel = resid / stop``, where ``stop = max(rtol*|B|, atol)`` for
    iterative methods and the normwise backward-error floor
    ``100*eps*(|A|*|X| + |B|)`` for the direct methods (exactsolve,
    kron_direct, which additionally flags singular pencils).  "fused_cg",
    "scipy_gmres" and "broyden1" do not report info: ``return_info=True``
    raises for them.

    A :class:`ConvergenceWarning` is emitted when the solve did not
    converge.  The check always runs (PyTorch is eager): one extra matvec,
    norms and a host synchronisation per call, before returning.  The one
    exception is ``method="structured_cg"`` on CUDA tensors, whose kernels
    run without a synchronise: its verdict is copied to the host behind the
    solve, and the warning is emitted by the first later call of
    :func:`solve` that finds the copy done, by
    :func:`flush_convergence_warnings`, or at the interpreter's exit.  For
    a :class:`TridiagLowRankOperator` in float32 on CUDA tensors (without
    M) the check is one kernel launch (ops/tlr.py) instead of the
    matvec and norms.
    """
    with span("xt.solve"):
        return _solve(A, B, E, M, bck_options, method, return_info, fwd_options)


def _solve(A, B, E, M, bck_options, method, return_info, fwd_options):
    if not tracing():
        with span("xt.solve.pending"):
            _report_pending(wait=False)
    if A.shape[-1] != A.shape[-2]:
        raise RuntimeError("The linear operator A must have a square shape")
    if A.shape[-1] != B.shape[-2]:
        raise RuntimeError(
            "Mismatch shape of A & B (A: %s, B: %s)" % (A.shape, tuple(B.shape)))
    if M is not None:
        if M.shape[-1] != M.shape[-2]:
            raise RuntimeError("The linear operator M must have a square shape")
        if M.shape[-1] != A.shape[-1]:
            raise RuntimeError(
                "The shape of A & M must match (A: %s, M: %s)" % (A.shape, M.shape))
        if not M.is_hermitian:
            raise RuntimeError("The linear operator M must be a Hermitian matrix")
    if E is not None and E.shape[-1] != B.shape[-1]:
        raise RuntimeError(
            "The last dimension of E & B must match (E: %s, B: %s)"
            % (tuple(E.shape), tuple(B.shape)))
    if E is None and M is not None:
        warnings.warn("M is supplied but will be ignored because E is not supplied")

    if is_debug_enabled():
        A.check()
        if M is not None:
            M.check()

    if method is None:
        method = _default_method(A, E, M)

    if method == "exactsolve":
        # dense path: differentiable natively (incl. higher order)
        with span("xt.solve.method"):
            return exactsolve(A, B, E, M, return_info=return_info)

    method_fcn = get_method("solve", _SOLVE_METHODS, method)
    bck_cfg = dict(bck_options)
    bck_method = bck_cfg.pop("method", method)
    get_method("solve", _SOLVE_METHODS, bck_method)

    if return_info and isinstance(method, str) and method not in _INFO_METHODS:
        raise RuntimeError(
            "return_info=True is not supported for method %r "
            "(supported: %s, or a custom callable returning (x, info))"
            % (method, sorted(_INFO_METHODS)))

    # broadcast B to the full output batch so matvec is shape-preserving
    batchdims = get_batchdims(A, B, E, M)
    B2 = B.expand(*batchdims, A.shape[-1], B.shape[-1])

    prob = _Problem(A, M, method_fcn, fwd_options, bck_method, bck_cfg,
                    return_info)
    params = _params(A, M)
    out = _SolveFunction.apply(prob, B2, E, *params)
    with span("xt.solve.check"):
        if return_info:
            x, info = out[0], dict(zip(prob.info_keys, out[1:]))
            _warn_nonconverged_eager("solve", method, info)
            return x, info
        _warn_eager(A, B2, E, M, out, method, fwd_options)
    return out


def _default_method(A, E, M) -> str:
    kron = (KronOperator, KronSumOperator)
    if M is None and A.is_hermitian and isinstance(A, kron):
        # the factor-eigenbasis direct solve: materialising a Kronecker
        # structure is O((prod n_i)^2) memory
        return "kron_direct"
    if isinstance(A, kron) or isinstance(M, kron):
        # Kron operators outside the kron_direct guard (M-generalized or
        # non-hermitian factors) must NOT hit the fullmatrix branch below (a
        # 3-factor 64^3 KronSum is ~275 GB dense).  Stay matrix-free.
        if A.is_hermitian and (M is None or M.is_hermitian):
            return "cg" if E is None else "minres"
        return "bicgstab"
    if isinstance(A, (TridiagLowRankOperator, BandedLowRankOperator)):
        # structured operators implement _fullmatrix for testing, but
        # materializing them defeats their purpose (B=512, n=1024 is
        # ~2 GB dense)
        pure_tridiag = A.V is None and (
            isinstance(A, TridiagLowRankOperator) or A.offsets in ((), (1,)))
        if E is not None and not pure_tridiag:
            # symeig's implicit-gradient shifts sit inside the spectrum, so
            # A - eI is indefinite; the fused CG kernel has no posdef probe
            # or best-iterate tracking.  minres handles indefinite
            # hermitian systems directly.  Pure tridiagonal shifts keep the
            # direct Thomas path, whose info reports a measured residual.
            return "minres"
        return "structured_cg"
    if A.is_fullmatrix_implemented and (M is None or M.is_fullmatrix_implemented):
        return "exactsolve"
    if A.shape[-1] <= 5:
        return "exactsolve"
    if A.is_hermitian and (M is None or M.is_hermitian):
        # E-shifted hermitian pencils are indefinite by construction
        return "cg" if E is None else "minres"
    return "bicgstab"


def _params(A, M):
    params = list(A.getlinopparams())
    if M is not None:
        seen = {id(p) for p in params}
        params += [p for p in M.getlinopparams() if id(p) not in seen]
    return params


class _Problem:
    """What the autograd function needs besides its tensor inputs."""

    def __init__(self, A, M, method_fcn, fwd_options, bck_method, bck_cfg,
                 return_info):
        self.A = A
        self.M = M
        self.method_fcn = method_fcn
        self.fwd_options = fwd_options
        self.bck_method = bck_method
        self.bck_cfg = bck_cfg
        self.return_info = return_info
        self.info_keys = ()


class _SolveFunction(torch.autograd.Function):
    """Inputs ``(prob, B2, E, *params)``; ``params`` are the parameter
    tensors of A and M (the same objects the operators hold)."""

    @staticmethod
    def forward(ctx, prob, B2, E, *params):
        if prob.return_info:
            with span("xt.solve.method"):
                x, info = prob.method_fcn(prob.A, B2, E, prob.M, return_info=True,
                                          **prob.fwd_options)
            prob.info_keys = tuple(info)
            vals = tuple(torch.as_tensor(v, dtype=torch.float32, device=x.device)
                         .clone() for v in info.values())
            ctx.mark_non_differentiable(*vals)
        else:
            with span("xt.solve.method"):
                x = prob.method_fcn(prob.A, B2, E, prob.M, **prob.fwd_options)
            vals = ()
        ctx.prob = prob
        ctx.save_for_backward(x, E)
        return (x, *vals) if prob.return_info else x

    @staticmethod
    def backward(ctx, gx, *ginfo):
        with span("xt.solve.backward"):
            prob = ctx.prob
            x, E = ctx.saved_tensors
            A, M = prob.A, prob.M
            need = ctx.needs_input_grad
            if gx is None:
                return (None,) * len(need)
            # adjoint solve A^H lam - M^H lam E^* = g, through the public
            # (differentiable) solve so that double backward works
            Eb = E.conj() if E is not None else None
            lam = solve(A.H, gx, Eb, M.H if M is not None else None,
                        bck_options=prob.bck_cfg, method=prob.bck_method,
                        **prob.bck_cfg)

            params = _params(A, M)
            grads = [None] * len(need)
            if need[1]:
                grads[1] = lam
            wrt = [i for i, p in enumerate(params) if need[3 + i]]
            if need[2] or wrt:
                create = torch.is_grad_enabled()  # True only in double backward
                fused = _fused_param_grads(A, M, x, lam, E, need, create) \
                    if x.is_cuda else None
                if fused is not None:
                    grads[2:] = fused
                    return tuple(grads)
                # stand-ins of the parameters: the derivative of A X - M X E
                # with X held fixed (X's own graph leads to the originals)
                with torch.enable_grad(), ExitStack() as stack:
                    alias = {id(params[i]): params[i].view_as(params[i]) for i in wrt}
                    stack.enter_context(A._replaced_params(alias))
                    if M is not None:
                        stack.enter_context(M._replaced_params(alias))
                    inputs = [alias[id(params[i])] for i in wrt]
                    r = A.mm(x)
                    if E is not None:
                        Ea = E.view_as(E)
                        if need[2]:
                            inputs.append(Ea)
                        Mx = M.mm(x) if M is not None else x
                        r = r - Mx * Ea[..., None, :]
                    gs = torch.autograd.grad(r, inputs, -lam, create_graph=create,
                                             allow_unused=True)
                for i, g in zip(wrt, gs):
                    grads[3 + i] = torch.zeros_like(params[i]) if g is None else g
                if need[2]:
                    grads[2] = torch.zeros_like(E) if gs[-1] is None else gs[-1]
            return tuple(grads)


def _tlr_route(A, M, *tensors) -> bool:
    """Whether the problem is one for ops/tlr.py's kernels: a
    :class:`TridiagLowRankOperator` without M, its parameters and every
    tensor given (None skipped) in float32.  The kernels' window and layout
    are ops/tlr.py's to decide."""
    return (M is None and isinstance(A, TridiagLowRankOperator)
            and all(t.dtype == torch.float32
                    for t in (A.d, A.c, A.V, *tensors) if t is not None))


def _fused_param_grads(A, M, x, lam, E, need, create) -> Optional[list]:
    """The gradients to E and to A's parameters, ``[gE, *per parameter]``
    in the order of ``_SolveFunction``'s inputs (None where not needed),
    from the gradient operator (ops/tlr.py; the kernel on CUDA tensors, its
    plain version on CPU tensors) where it takes the problem: a first-order
    backward (``create`` False) on :func:`_tlr_route`, whose parameters are
    the operator's own d, c and V, and whose tensors that need a gradient
    are not broadcast along the system axis, in the kernel's layout.  None
    otherwise: the generic ``autograd.grad`` through ``A.mm(x)`` runs.
    :meth:`_SolveFunction.backward` asks it for CUDA tensors only."""
    if create or not _tlr_route(A, M, x, lam, E):
        return None
    own = [A.d, A.c] + ([A.V] if A.V is not None else [])
    if [id(p) for p in _params(A, M)] != [id(t) for t in own]:
        return None
    need_d, need_c = need[3], need[4]
    need_V = A.V is not None and need[5]
    got = tlr_param_grads(A.d, A.c, A.V, x, lam, E, need_d, need_c, need_V, need[2])
    return None if got is None else list(got[:1 + len(own)])


def _warn_eager(A, B2, E, M, x, method, fwd_options) -> None:
    """Warn if the returned solution's measured residual is above 10x the
    tolerance (one extra matvec, or the fused residual kernel where
    :func:`_fused_verdict` takes the problem).  For structured_cg on CUDA
    tensors the verdict is queued (:func:`_report_pending`) instead of
    read, so the call does not synchronise.  Skipped while a program is
    traced."""
    if tracing():
        return
    rtol = fwd_options.get("rtol", 1e-6)
    atol = fwd_options.get("atol", 1e-8)
    direct = isinstance(method, str) and method in _DIRECT_METHODS
    with torch.no_grad():
        verdict = _fused_verdict(A, B2, E, M, x, method, rtol, atol) if x.is_cuda else None
        if verdict is None:
            Ax = A.mm(x)
            if E is not None:
                Mx = M.mm(x) if M is not None else x
                Ax = Ax - Mx * E[..., None, :]
            resid, stop = _residual_rule(Ax, B2, rtol, atol, -2,
                                         torch.finfo(x.dtype).eps if direct else None)
            if resid.numel() == 0:
                return
            verdict = residual_verdict(resid, stop)
        if verdict.is_cuda and method == "structured_cg":
            host = torch.empty(3, dtype=verdict.dtype, pin_memory=True)
            with torch.cuda.device(verdict.device):
                host.copy_(verdict, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            _PENDING.append((done, host, method))
            return
    _warn_verdict(verdict, method)


def _fused_verdict(A, B2, E, M, x, method, rtol, atol) -> Optional[torch.Tensor]:
    """The check's verdict from the residual operator (ops/tlr.py; the
    fused kernel on CUDA tensors, its plain version on CPU tensors) where
    it takes the problem: on :func:`_tlr_route`, not a direct method (whose
    stop needs ``||Ax||``), in the kernel's layout.  None otherwise: the
    generic check runs.  :func:`_warn_eager` asks it for CUDA tensors
    only."""
    if (isinstance(method, str) and method in _DIRECT_METHODS) \
            or not _tlr_route(A, M, x, B2, E):
        return None
    return tlr_residual_check(A.d, A.c, A.V, x, B2, E, rtol, atol)


def _warn_verdict(verdict: torch.Tensor, method) -> None:
    failed, resid, stop = verdict.tolist()
    if failed:
        warnings.warn(ConvergenceWarning(
            "solve (method=%s) did not converge: max residual %.3e "
            "(tolerance %.3e); the best iterate is returned" % (method, resid, stop)))


def _report_pending(wait: bool) -> None:
    """Emit the warnings of the queued eager checks whose copy has reached
    the host (``wait``: of all of them, waiting for each)."""
    while _PENDING:
        done, host, method = _PENDING[0]
        if wait:
            done.synchronize()
        elif not done.query():
            return
        _PENDING.pop(0)
        _warn_verdict(host, method)


def flush_convergence_warnings() -> None:
    """Wait for the eager convergence checks of earlier structured_cg
    :func:`solve` calls on CUDA tensors and emit their warnings now (a host
    synchronisation)."""
    _report_pending(wait=True)


atexit.register(flush_convergence_warnings)


def _warn_nonconverged_eager(what: str, method, info) -> None:
    conv = info.get("converged", None)
    if conv is None or tracing():
        return
    if float(conv) < 1.0:
        warnings.warn(ConvergenceWarning(
            "%s (method=%s) did not converge after %d iterations "
            "(final residual %.3e, %.1fx the tolerance); the best iterate "
            "is returned" % (what, method, int(info["iterations"]),
                             float(info["resid"]), float(info["resid_rel"]))))


# docstring completion: each method's options
from xitorch_tpu_torch._docstr.api_docstr import get_methods_docstr  # noqa: E402

solve.__doc__ = get_methods_docstr(solve, _SOLVE_METHODS, ignore_kwargs=["E", "M"])
