"""Differentiable linear solve ``AX = B`` / ``AX - MXE = B`` (counterpart of
xitorch_tpu/linalg/solve.py).

* forward: the selected method runs as a black box without gradients
  (gradients never flow through solver iterations);
* backward: a ``torch.autograd.Function`` solves the adjoint system
  ``A^H lam = g`` with this module's own public :func:`solve` (so the
  backward is differentiable again), and the gradients to E and to the
  parameters of A and M are ``torch.autograd.grad`` of
  ``-<lam, A X - M X E>`` at fixed X, created with a graph whenever
  gradients are enabled: first and second order both work.
"""
from __future__ import annotations

import warnings
from contextlib import ExitStack
from typing import Any, Callable, Mapping, Optional, Union

import torch

from xitorch_tpu_torch._core.linop import LinearOperator
from xitorch_tpu_torch._core.structured import (
    BandedLowRankOperator, TridiagLowRankOperator,
)
from xitorch_tpu_torch._impls.linalg.solve import (
    _make_info, cg, exactsolve, get_batchdims, minres,
)
from xitorch_tpu_torch.debug.modes import is_debug_enabled
from xitorch_tpu_torch.ops.structured_cg import fits_structured_cg, structured_cg_solve
from xitorch_tpu_torch.ops.tridiag import tridiag_matvec, tridiag_solve_kernel
from xitorch_tpu_torch.utils.exceptions import ConvergenceWarning
from xitorch_tpu_torch.utils.misc import get_method

__all__ = ["solve"]


def _structured_cg(A, B, E=None, M=None, rtol: float = 1e-6,
                   atol: float = 1e-8, max_niter=None,
                   return_info: bool = False, **options):
    """Fused solve for :class:`TridiagLowRankOperator` and
    :class:`BandedLowRankOperator`: the CG kernel keeps the whole CG state
    and the operator data of a system in shared memory
    (ops/structured_cg.py).  Pure tridiagonal operators (V is None) get a
    *direct* Thomas solve instead of CG.  Per-column diagonal shifts E
    (M=None) keep the structure — ``A - e_j I`` just shifts d.

    On CUDA tensors the kernels launch (or raise); on CPU tensors their
    plain PyTorch versions run.  Any other operator, float64, or an
    M-generalized shift goes to the matrix-free cg, as in the JAX
    package; so does a system too large for one block's shared memory."""
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
            r = torch.linalg.norm(ax - bT, dim=-1)
            bn = torch.linalg.norm(bT, dim=-1)
            eps_d = torch.finfo(x.dtype).eps
            scale = torch.linalg.norm(ax, dim=-1) + bn
            stop = torch.maximum(torch.clamp(rtol * bn, min=atol),
                                 100 * eps_d * scale)
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
        rT = ax.transpose(-1, -2) - bT
        rc = torch.linalg.norm(rT, dim=-1)
        bnorm = torch.linalg.norm(bT, dim=-1)
        stop = torch.clamp(rtol * bnorm, min=atol)
        rel = (rc / stop).max()
        return x, _make_info(rel < 1.0, it.max(), rc.max(), rel)
    return x


_SOLVE_METHODS = {
    "cg": cg,
    "structured_cg": _structured_cg,
    "minres": minres,
    "exactsolve": exactsolve,
    "custom_exactsolve": exactsolve,
}

# methods whose impl supports the (x, info) return convention
_INFO_METHODS = {"cg", "minres", "exactsolve", "custom_exactsolve", "structured_cg"}

# methods of the JAX package that later slices of the port bring
_LATER_METHODS = {"cg_ir", "fused_cg", "kron_direct", "bicgstab", "gmres",
                  "scipy_gmres", "broyden1"}


def _get_solve_method(method):
    if isinstance(method, str) and method.lower() in _LATER_METHODS:
        raise RuntimeError(
            "solve method %r is not ported to xitorch_tpu_torch yet: it "
            "belongs to slice 6 of the port (ROADMAP.md, queue 1); "
            "ported methods: %s" % (method, ", ".join(sorted(_SOLVE_METHODS))))
    return get_method("solve", _SOLVE_METHODS, method)


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
    ("cg", "minres", "exactsolve", "custom_exactsolve", "structured_cg") or
    a custom callable; None picks structured_cg for structured operators
    (minres when they are E-shifted and not purely tridiagonal),
    exactsolve for explicit/small operators, else cg for hermitian
    operators (minres when E-shifted).

    Returns ``X (*BABEM, na, ncols)``; first and second order gradients flow
    to B, E, and the parameters of A and M by implicit differentiation.
    ``bck_options`` configures the adjoint solve of the backward pass
    (``"method"`` plus that method's options).

    With ``return_info=True``, returns ``(X, info)`` where ``info`` is a dict
    ``{"converged", "iterations", "resid", "resid_rel"}`` of float32
    scalars without gradients: ``resid`` is the measured residual norm of
    the returned iterate and ``converged = resid_rel < 1.0``.

    A :class:`ConvergenceWarning` is emitted when the solve did not
    converge.  The check always runs (PyTorch is eager): one extra matvec,
    norms and a host synchronisation per call.
    """
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
        if return_info:
            return exactsolve(A, B, E, M, return_info=True)
        return exactsolve(A, B, E, M)

    method_fcn = _get_solve_method(method)
    bck_cfg = dict(bck_options)
    bck_method = bck_cfg.pop("method", method)
    _get_solve_method(bck_method)

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
    if return_info:
        x, info = out[0], dict(zip(prob.info_keys, out[1:]))
        _warn_nonconverged_eager("solve", method, info)
        return x, info
    x = out
    _warn_eager(A, B2, E, M, x, method, fwd_options)
    return x


def _default_method(A, E, M) -> str:
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
            x, info = prob.method_fcn(prob.A, B2, E, prob.M, return_info=True,
                                      **prob.fwd_options)
            prob.info_keys = tuple(info)
            vals = tuple(torch.as_tensor(v, dtype=torch.float32, device=x.device)
                         .clone() for v in info.values())
            ctx.mark_non_differentiable(*vals)
        else:
            x = prob.method_fcn(prob.A, B2, E, prob.M, **prob.fwd_options)
            vals = ()
        ctx.prob = prob
        ctx.save_for_backward(x, E)
        return (x, *vals) if prob.return_info else x

    @staticmethod
    def backward(ctx, gx, *ginfo):
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
            # stand-ins of the parameters: the derivative of A X - M X E
            # with X held fixed (X's own graph leads to the originals)
            create = torch.is_grad_enabled()  # True only in double backward
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


def _warn_eager(A, B2, E, M, x, method, fwd_options) -> None:
    """Warn if the returned solution's measured residual is above 10x the
    tolerance (one extra matvec and a host synchronisation)."""
    rtol = fwd_options.get("rtol", 1e-6)
    atol = fwd_options.get("atol", 1e-8)
    with torch.no_grad():
        Ax = A.mm(x)
        if E is not None:
            Mx = M.mm(x) if M is not None else x
            Ax = Ax - Mx * E[..., None, :]
        resid = torch.linalg.norm(Ax - B2, dim=-2)
        bnorm = torch.linalg.norm(B2, dim=-2)
        stop = torch.clamp(rtol * bnorm, min=atol)
        if isinstance(method, str) and method in ("exactsolve", "custom_exactsolve"):
            # direct methods have no iteration tolerance: their residual
            # floor is the backward-error bound ~eps*(|Ax| + |B|)
            eps_d = torch.finfo(x.dtype).eps
            scale = torch.linalg.norm(Ax, dim=-2) + bnorm
            stop = torch.maximum(stop, 100 * eps_d * scale)
        if bool((resid > 10 * stop).any()):
            warnings.warn(ConvergenceWarning(
                "solve (method=%s) did not converge: max residual %.3e "
                "(tolerance %.3e); the best iterate is returned"
                % (method, float(resid.max()), float(stop.max()))))


def _warn_nonconverged_eager(what: str, method, info) -> None:
    conv = info.get("converged", None)
    if conv is None:
        return
    if float(conv) < 1.0:
        warnings.warn(ConvergenceWarning(
            "%s (method=%s) did not converge after %d iterations "
            "(final residual %.3e, %.1fx the tolerance); the best iterate "
            "is returned" % (what, method, int(info["iterations"]),
                             float(info["resid"]), float(info["resid_rel"]))))
