"""Symmetric-eigendecomposition methods: dense (degeneracy-safe) and
iterative (counterpart of xitorch_tpu/_impls/linalg/symeig.py).

* ``degen_eigh`` / ``degen_svd``: dense decompositions whose gradients
  drop the ill-defined rotation inside (near-)degenerate blocks.  Each is
  a ``torch.autograd.Function``; its backward is the transpose of the
  reference's tangent rule, taken with differentiable operations, so it
  can be differentiated again.  On a CUDA float32 or complex64 tensor
  inside the kernels' window the decomposition runs the Jacobi sweep
  kernels (ops/jacobi_eigh.py); elsewhere it is ``torch.linalg.eigh`` /
  ``torch.linalg.svd``.  For complex input the rules drop the per-column
  phase term, which is valid for losses that do not depend on the phases
  of the eigenvectors or singular vectors.
* ``exacteig``: dense path with the M-Cholesky symmetrisation.
* ``kron_exacteig``: exact eigenpairs of a hermitian Kronecker-structured
  operator from its factor decompositions.
* ``davidson``: fixed-subspace block Davidson with thick restart (basis
  [Ritz vectors X, residuals R, previous X], Cholesky-QR).
* ``chebfsi``: Chebyshev-filtered subspace iteration.

The iterative methods run without gradients; ``linalg.symeig`` wraps them
in the implicit-function rule.  Their random draws come from
``torch.Generator``s with the reference's seeds; the streams differ from
the reference's, so only converged results compare.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Sequence, Tuple

import torch

from xitorch_tpu_torch._core.linop import LinearOperator, MatrixLinearOperator
from xitorch_tpu_torch.debug.profiling import span
from xitorch_tpu_torch.utils.bcast import get_bcasted_dims
from xitorch_tpu_torch.utils.tensor import dot_hi, tallqr

__all__ = ["exacteig", "kron_exacteig", "degen_eigh", "degen_svd", "davidson",
           "chebfsi", "take_eigpairs"]


def take_eigpairs(eival: torch.Tensor, eivec: torch.Tensor, neig: int, mode: str):
    """Select neig eigenpairs from a full (ascending) decomposition."""
    if mode == "lowest":
        return eival[..., :neig], eivec[..., :neig]
    return eival[..., -neig:], eivec[..., -neig:]


def _rr_eigh(T: torch.Tensor):
    """Solver-internal Rayleigh-Ritz/subspace eigh: ``dense_eigh``, so the
    sweep kernel takes a batch where its measured gate says it wins, and
    everything else (the 16-32 wide matrices of the usual block sizes among
    it) goes to ``torch.linalg.eigh``.  Gradients never pass through this."""
    from xitorch_tpu_torch.ops.jacobi_eigh import dense_eigh

    return dense_eigh(T)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).detach().clone()


def _direct_info(device):
    return {"converged": _f32(1.0, device), "iterations": _f32(1.0, device),
            "resid": _f32(0.0, device), "resid_rel": _f32(0.0, device)}


# ------------------------------------------------------------------
# degeneracy-safe dense decompositions
# ------------------------------------------------------------------

def _transpose_rule(rule: Callable, like: torch.Tensor,
                    cotangents: Sequence[Optional[torch.Tensor]],
                    create_graph: bool) -> torch.Tensor:
    """Cotangent of ``dA`` under the linear tangent rule ``rule(dA) ->
    tangents``: its transpose applied to ``cotangents``.  The rule is run
    on a stand-in ``dA`` and differentiated; with ``create_graph`` the
    result stays differentiable in everything the rule closes over."""
    with torch.enable_grad():
        dA = torch.zeros_like(like, requires_grad=True)
        outs = rule(dA)
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        if not pairs:
            return torch.zeros_like(like)
        (gA,) = torch.autograd.grad([o for o, _ in pairs], [dA],
                                    [g for _, g in pairs],
                                    create_graph=create_graph, allow_unused=True)
    return torch.zeros_like(like) if gA is None else gA


def _masked_inverse(diff: torch.Tensor, degen: torch.Tensor) -> torch.Tensor:
    """1/diff with the entries flagged by ``degen`` set to 0."""
    return torch.where(degen, torch.zeros_like(diff),
                       1.0 / torch.where(degen, torch.ones_like(diff), diff))


def _eigh_tangents(evals, evecs, dA):
    """Tangent rule of ``degen_eigh``: F_ij = 1/(lam_j - lam_i), masked to 0
    on (near-)degenerate pairs and the diagonal."""
    dS = dot_hi(dot_hi(evecs.mH, dA), evecs)  # (*B, n, n)
    devals = torch.diagonal(dS, dim1=-2, dim2=-1).real.to(evals.dtype)
    min_threshold = torch.finfo(evals.dtype).eps ** 0.6
    diff = evals[..., None, :] - evals[..., :, None]  # lam_j - lam_i
    Fm = _masked_inverse(diff, diff.abs() <= min_threshold)
    devecs = dot_hi(evecs, Fm * dS)
    return devals, devecs


def _svd_tangents(u, s, v, dA):
    """Tangent rule of ``degen_svd``: the pair couplings 1/(s_j^2 - s_i^2)
    of (near-)degenerate pairs, the 1/s_i null-space terms of (near-)zero
    singular values and, for complex input, the per-column phase term are
    dropped."""
    dP = dot_hi(dot_hi(u.mH, dA), v)  # (*B, r, r)
    ds = torch.diagonal(dP, dim1=-2, dim2=-1).real.to(s.dtype)
    s2 = s * s
    min_threshold = torch.finfo(s.dtype).eps ** 0.6
    diff = s2[..., None, :] - s2[..., :, None]  # s_j^2 - s_i^2
    Fm = _masked_inverse(diff, diff.abs() <= min_threshold).to(dP.dtype)
    # X = F o (dP S + S dP^H), Y = F o (S dP + dP^H S) solve the first-order
    # constraints dP = X S + dS - S Y with X, Y anti-hermitian
    dPH = dP.mH
    sc = s[..., :, None].to(dP.dtype)
    sr = s[..., None, :].to(dP.dtype)
    du = dot_hi(u, Fm * (dP * sr + sc * dPH))
    dv = dot_hi(v, Fm * (sc * dP + dPH * sr))
    # null-space coupling (economy SVD, m != n): (I - U U^H) dA V S^-1 and
    # (I - V V^H) dA^H U S^-1, with 1/s masked for near-zero s
    small = s2 <= min_threshold
    sinv = _masked_inverse(s, small).to(dP.dtype)[..., None, :]
    du = du + (dot_hi(dA, v) - dot_hi(u, dP)) * sinv
    dv = dv + (dot_hi(dA.mH, u) - dot_hi(v, dPH)) * sinv
    return du, ds, dv


class _DegenEigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        from xitorch_tpu_torch.ops.jacobi_eigh import dense_eigh
        evals, evecs = dense_eigh(A)
        ctx.save_for_backward(evals, evecs)
        return evals, evecs

    @staticmethod
    def backward(ctx, gevals, gevecs):
        evals, evecs = ctx.saved_tensors
        with span("xt.symeig.backward"):
            return _transpose_rule(lambda dA: _eigh_tangents(evals, evecs, dA),
                                   evecs, (gevals, gevecs), torch.is_grad_enabled())


class _DegenSvd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        from xitorch_tpu_torch.ops.jacobi_eigh import dense_svd
        u, s, v = dense_svd(A)
        ctx.save_for_backward(A, u, s, v)
        return u, s, v

    @staticmethod
    def backward(ctx, gu, gs, gv):
        A, u, s, v = ctx.saved_tensors
        return _transpose_rule(lambda dA: _svd_tangents(u, s, v, dA),
                               A, (gu, gs, gv), torch.is_grad_enabled())


def degen_eigh(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` with degeneracy-safe gradients.

    The standard eigh derivative has 1/(lam_j - lam_i) factors that blow
    up for degenerate eigenvalues; the contribution of (near-)degenerate
    pairs (|lam_j - lam_i| <= eps**0.6) is dropped, which is valid
    whenever the loss is invariant under rotations within the degenerate
    subspace.  The decomposition is ``ops/jacobi_eigh.py::dense_eigh``: on
    a CUDA float32 or complex64 tensor with 64 <= n <= 1024 the Jacobi sweep
    kernels run where the measured gate says they beat the library, and
    ``torch.linalg.eigh`` (with one Newton orthonormalisation step there)
    elsewhere; set ``xitorch_tpu_torch.ops.jacobi_eigh.ENABLED = False`` to
    close the gate."""
    return _DegenEigh.apply(A)


def degen_svd(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Economy SVD ``A = U diag(s) V^H`` with degeneracy-safe gradients and
    **ascending** singular values (the package-wide ordering).  Returns
    ``(U, s, V)``.

    The decomposition is ``ops/jacobi_eigh.py::dense_svd``: on a CUDA
    float32 or complex64 tensor inside the kernels' window, where the
    measured gate says it wins, the Hestenes one-sided Jacobi sweep kernel
    on the columns of A (complex input on packed planes; no Gram matrix, so
    singular values keep ~eps*kappa(A) relative error); elsewhere
    ``torch.linalg.svd`` flipped to ascending."""
    return _DegenSvd.apply(A)


def exacteig(A: LinearOperator, neig: int, mode: str,
             M: Optional[LinearOperator] = None,
             return_info: bool = False, **unused):
    """Eigendecomposition by materialising the operator.  No additional
    options.  Differentiable natively (including second order)."""
    if return_info:
        evals, evecs = exacteig(A, neig, mode, M)
        return evals, evecs, _direct_info(evals.device)
    Amatrix = A.fullmatrix()
    if M is None:
        evals, evecs = degen_eigh(Amatrix)
        return take_eigpairs(evals, evecs, neig, mode)
    Mmatrix = M.fullmatrix()
    L = torch.linalg.cholesky(Mmatrix)
    # triangular solve instead of inv(L): faster and more accurate
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    LinvT = Linv.mH
    # batch = broadcast of BOTH operands (M may carry batch dims A lacks)
    bcast = torch.broadcast_shapes(Amatrix.shape[:-2], L.shape[:-2])
    A2 = torch.linalg.solve_triangular(
        L.expand(*bcast, *L.shape[-2:]),
        dot_hi(Amatrix, LinvT).expand(*bcast, *Amatrix.shape[-2:]), upper=False)
    A2 = (A2 + A2.mH) * 0.5
    evals, evecs = degen_eigh(A2)
    evals, evecs = take_eigpairs(evals, evecs, neig, mode)
    return evals, dot_hi(LinvT, evecs)  # M-orthonormal eigenvectors


def kron_exacteig(A, neig: int, mode: str,
                  M: Optional[LinearOperator] = None,
                  return_info: bool = False, **unused):
    """Exact eigenpairs of a hermitian Kronecker-structured operator from
    its *factor* decompositions (see _core/kron.py).

    For ``KronSumOperator`` the eigenvalues are all sums
    ``sum_i l_i[j_i]`` with eigenvectors ``v_1[j_1] (x) ... (x) v_k[j_k]``;
    for ``KronOperator`` the products.  One small decomposition per factor
    (the Jacobi sweep kernel for CUDA float32 factors inside its window)
    and a sort of the combined spectrum: O(sum n_i^3) instead of
    O((prod n_i)^3).  Natively differentiable through ``degen_eigh`` (the
    same contract as exacteig); mixed-index eigenvalue crossings cost
    nothing, because gradients flow through the factor decompositions
    independently.
    """
    from xitorch_tpu_torch._core.kron import KronOperator, KronSumOperator

    if M is not None:
        raise RuntimeError("kron_exact does not support a generalized "
                           "(M != None) problem")
    if not isinstance(A, (KronOperator, KronSumOperator)):
        raise RuntimeError(
            "kron_exact requires a KronOperator/KronSumOperator "
            "(got %s)" % type(A).__name__)
    if not A.is_hermitian:
        raise RuntimeError("kron_exact requires hermitian factors "
                           "(declare is_hermitian=True)")

    comb, Vs = A.combined_eigendecomposition()
    batch = comb.shape[:-len(A.dims)]
    flat = comb.reshape(*batch, A.shape[-1])
    order = torch.argsort(flat, dim=-1)
    sel = order[..., :neig] if mode == "lowest" else order[..., -neig:]
    lam = torch.take_along_dim(flat, sel, dim=-1)        # (*B, neig)
    # row-major multi-index of each selected flat position, last axis
    # fastest; eigenvector = product of gathered factor columns
    idx = sel
    gathered = []
    for d, V in zip(reversed(A.dims), reversed(Vs)):
        ji = idx % d
        idx = idx // d
        gathered.append(torch.take_along_dim(V.expand(*batch, d, d),
                                             ji[..., None, :], dim=-1))
    evecs = None                                         # (*B, prod, neig)
    for Vg in reversed(gathered):                        # factor order
        evecs = Vg if evecs is None else (
            evecs[..., :, None, :] * Vg[..., None, :, :]).reshape(
                *batch, evecs.shape[-2] * Vg.shape[-2], neig)
    if return_info:
        return lam, evecs, _direct_info(lam.device)
    return lam, evecs


# ------------------------------------------------------------------
# shared pieces of the iterative methods
# ------------------------------------------------------------------

def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _randn(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device).to(dtype)


def _colnorm(W: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((W.abs() ** 2).sum(-2, keepdim=True))


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.ones_like(x), x)


def _finite(*ts: torch.Tensor) -> torch.Tensor:
    ok = torch.isfinite(ts[0]).all()
    for t in ts[1:]:
        ok = ok & torch.isfinite(t).all()
    return ok


def _iter_info(best_resid, min_eps, niter, device):
    return {"converged": _f32(best_resid < min_eps, device),
            "iterations": _f32(niter, device),
            "resid": _f32(best_resid, device),
            "resid_rel": _f32(best_resid / min_eps, device)}


def _set_initial_v(vinit_type: str, dtype, device, batch_dims, na: int, nguess: int,
                   M: Optional[LinearOperator] = None) -> torch.Tensor:
    # fixed seed for determinism (the reference's 12421)
    gen = _generator(12421, device)
    shape = (*batch_dims, na, nguess)
    if vinit_type == "eye":
        V = torch.eye(na, nguess, dtype=dtype, device=device).expand(shape)
    elif vinit_type == "randn":
        V = _randn(gen, shape, dtype)
    elif vinit_type in ("rand", "random"):
        V = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype)
    else:
        raise ValueError("Unknown v_init type: %s" % vinit_type)
    MV = M.mm(V) if isinstance(M, LinearOperator) else None
    V, _ = tallqr(V, MV=MV)
    return V


# ------------------------------------------------------------------
# matrix-free block Davidson (thick restart / LOBPCG-shaped)
# ------------------------------------------------------------------

def davidson(A: LinearOperator, neig: int, mode: str,
             M: Optional[LinearOperator] = None,
             max_niter: int = 1000,
             nguess: Optional[int] = None,
             v_init: str = "randn",
             max_addition: Optional[int] = None,
             min_eps: Optional[float] = 1e-6,
             precond=None,
             verbose: bool = False,
             return_info: bool = False,
             **unused):
    """Block Davidson for ``neig`` extreme eigenpairs of a hermitian
    (matrix-free) operator; generalized problem via M-orthonormal bases.

    Keyword arguments: max_niter, nguess (block size, default neig), v_init
    ("randn"/"rand"/"eye"), min_eps (bound on the elementwise-max residual;
    ``None`` = scale-aware ``eps**0.65 * scale(pencil)``, the auto-routed
    default).  ``max_addition`` is accepted for API parity; the fixed
    subspace holds [X, R, X_prev] (3 blocks).  ``precond``: optional
    LinearOperator or callable applied to the residual block before
    expansion.
    """
    if max_addition is not None:
        warnings.warn(
            "davidson(max_addition=...) is accepted for API parity with the "
            "reference but has no effect here: the fixed subspace always "
            "holds [X, R, X_prev] (documented deviation)")
    if nguess is None:
        nguess = neig
    nguess = max(nguess, neig)
    na = A.shape[-1]
    if M is None:
        bcast_dims = tuple(A.shape[:-2])
    else:
        bcast_dims = get_bcasted_dims(A.shape[:-2], M.shape[:-2])
    dtype, device = A.dtype, A.device

    block = min(nguess, na)
    s = min(3 * block, na)  # subspace = [X, R, P], capped at na

    V0 = _set_initial_v(v_init.lower(), dtype, device, bcast_dims, na, s, M=M)
    sign = 1.0 if mode == "lowest" else -1.0

    def mmM(X):
        return M.mm(X) if M is not None else X

    def rayleigh_ritz(V):
        # V is M-orthonormal, except columns that a rank-deficient subspace
        # zeroed out in the Cholesky-QR.  Those dead columns give zero
        # rows/cols of T whose 0 eigenvalues would sort FIRST on an SPD
        # spectrum in "lowest" mode; penalise them so they sort last.
        AV = A.mm(V)
        T = dot_hi(V.mH, AV)  # (*B, s, s)
        T = (T + T.mH) * 0.5
        # junk = any column whose M-norm deviates from 1 (a singular
        # Cholesky-QR leaves a continuum of junk norms, not clean zeros)
        cn = (V.conj() * mmM(V)).sum(-2).real  # (*B, s)
        dead = ((cn - 1.0).abs() > 0.1).to(cn.dtype)
        big = 10.0 * (T.abs().amax(dim=(-2, -1), keepdim=True) + 1.0)
        # the eigh below runs on sign*T, so the penalty lands at +big there
        T = T + torch.diag_embed((sign * big[..., 0] * dead).to(T.dtype))
        evalT, evecT = _rr_eigh(sign * T)
        evalT = sign * evalT
        # "uppest": eigh of -T sorts ascending in -lam, so the first block
        # are the largest lam (descending); flipped back at return
        evecT_sel = evecT[..., :block]
        X = dot_hi(V, evecT_sel)  # (*B, na, block)
        AX = dot_hi(AV, evecT_sel)
        return X, AX, evalT[..., :block]

    def residual(X, AX, lam):
        return AX - mmM(X) * lam[..., None, :]

    noise = _generator(7151, device)

    def _fix_block(W, X, MX):
        """M-orthogonalise the block against X, normalise columns, and
        replace (near-)degenerate columns with fresh noise, so the
        subspace [X, R, P] stays full-rank for the Cholesky-QR."""
        W = W - dot_hi(X, dot_hi(MX.mH, W))
        norms = _colnorm(W)
        fresh = _randn(noise, W.shape, W.dtype)
        W = torch.where(norms < 1e-8 * (norms.max() + 1e-30), fresh, W)
        return W / _nonzero(_colnorm(W))

    X0, AX0, lam0 = rayleigh_ritz(V0)
    R0 = residual(X0, AX0, lam0)
    resid0 = R0.abs().max()

    if min_eps is None:
        # scale-aware tolerance (the auto-routed default): min_eps is an
        # ABSOLUTE bound on the elementwise-max residual, so a fixed 1e-6
        # on a large-||A|| float32 pencil is unreachable.  Scale: a short
        # power iteration on ||A||_2 plus, for generalized pencils,
        # |lam| * ||M||_2.
        v0p = _randn(_generator(1117, device), (*bcast_dims, na, 1), dtype)

        def _pow_norm(op, v):
            for _ in range(8):
                w = op(v)
                v = w / torch.clamp(_colnorm(w), min=1e-30)
            return _colnorm(op(v)).max()

        scale = _pow_norm(A.mm, v0p)
        if M is not None:
            scale = scale + lam0.abs().max() * _pow_norm(M.mm, v0p)
        # eps**0.65 (tighter than chebfsi's sqrt(eps)): the measure here is
        # the ELEMENTWISE max of the residual block, ~sqrt(n) smaller than
        # the column norms that bound the eigenvalue error
        min_eps = (float(torch.finfo(scale.dtype).eps) ** 0.65) * scale * 1.01

    X, Xprev, lam, max_resid = X0, X0, lam0, resid0
    best_lam, best_X, best_resid = lam0, X0, resid0
    niter = 0
    inf = torch.tensor(float("inf"), dtype=resid0.dtype, device=device)
    while niter < max_niter and bool(max_resid >= min_eps):
        MX = mmM(X)
        R = A.mm(X) - MX * lam[..., None, :]
        if precond is not None:
            R = precond.mm(R) if isinstance(precond, LinearOperator) else precond(R)
        # new subspace from [X, R_orth, P_orth]
        Rb = _fix_block(R, X, MX)
        Pb = _fix_block(Xprev, X, MX)
        W = torch.cat([X, Rb, Pb], dim=-1)[..., :s]
        V, _ = tallqr(W, MV=mmM(W))
        Xn, AXn, lamn = rayleigh_ritz(V)
        resid_n = residual(Xn, AXn, lamn).abs().max()
        # validity: finite and properly M-normalised Ritz vectors (junk
        # subspaces from a singular Cholesky-QR give tiny/NaN columns)
        xnorms = _colnorm(Xn) if M is None else torch.sqrt(
            (Xn.conj() * mmM(Xn)).sum(-2, keepdim=True).abs())
        valid = _finite(lamn, Xn) & (xnorms.min() > 0.5) & (xnorms.max() < 1.5)
        better = (resid_n < best_resid) & valid
        best_lam = torch.where(better, lamn, best_lam)
        best_X = torch.where(better, Xn, best_X)
        best_resid = torch.where(better, resid_n, best_resid)
        max_resid = torch.where(valid, resid_n, inf)
        # on an invalid Rayleigh-Ritz (singular subspace), keep the previous
        # iterate and let the noise-refreshed blocks recover next round
        X, Xprev = torch.where(valid, Xn, X), X
        lam = torch.where(valid, lamn, lam)
        niter += 1

    lam_out = best_lam[..., :neig]
    X_out = best_X[..., :neig]
    if mode != "lowest":
        lam_out = lam_out.flip(-1)  # ascending order
        X_out = X_out.flip(-1)
    if return_info:
        return lam_out, X_out, _iter_info(best_resid, min_eps, niter, device)
    return lam_out, X_out


# ------------------------------------------------------------------
# Chebyshev-filtered subspace iteration
# ------------------------------------------------------------------

def chebfsi(A: LinearOperator, neig: int, mode: str,
            M: Optional[LinearOperator] = None,
            max_niter: int = 60,
            nguess: Optional[int] = None,
            v_init: str = "randn",
            min_eps: Optional[float] = 1e-6,
            degree: int = 24,
            polish: int = 2,
            fast_filter: bool = False,
            return_info: bool = False,
            **unused):
    """Chebyshev-filtered subspace iteration (Zhou et al. style) for
    ``neig`` extreme eigenpairs of a hermitian operator.

    Per Rayleigh-Ritz round it applies a degree-``degree`` scaled
    Chebyshev filter (``degree`` batched matrix products) that amplifies
    the spectrum below the cutoff by orders of magnitude.

    Keyword arguments: max_niter (RR rounds), nguess (block size, default
    ``max(2*neig, neig+6)``), degree, polish (extra LOBPCG-style rounds run
    ONLY if the filtered iteration leaves above ``min_eps``), fast_filter
    (filter products of an explicit matrix in TF32; the Rayleigh-Ritz,
    bounds and residuals stay in IEEE float32), min_eps (bound on the max
    column norm of the residual; ``None`` = scale-aware
    ``sqrt(eps) * ||A||``, the auto-routed default).

    Generalized problems (``M`` given): the filter runs in ``p(M^-1 A)``
    with M-orthonormal bases and Rayleigh-Ritz in the M-inner product.
    The M-solve is a Cholesky when ``M`` can be materialised, else a
    fixed-iteration CG; an approximate M-solve only perturbs the filter,
    never the Ritz pairs.
    """
    if nguess is None:
        nguess = max(2 * neig, neig + 6)
    na = A.shape[-1]
    block = min(max(nguess, neig), na)
    dtype, device = A.dtype, A.device
    if M is None:
        bcast_dims = tuple(A.shape[:-2])
    else:
        bcast_dims = get_bcasted_dims(A.shape[:-2], M.shape[:-2])
    sign = 1.0 if mode == "lowest" else -1.0

    def mmM(X):
        return M.mm(X) if M is not None else X

    # M^-1 application for the filter
    if M is None:
        def minv(X):
            return X
    elif M.is_fullmatrix_implemented:
        Lm = torch.linalg.cholesky(M.fullmatrix())

        def minv(X):
            bsh = torch.broadcast_shapes(Lm.shape[:-2], X.shape[:-2])
            LmB = Lm.expand(*bsh, *Lm.shape[-2:])
            y = torch.linalg.solve_triangular(LmB, X.expand(*bsh, *X.shape[-2:]),
                                              upper=False)
            return torch.linalg.solve_triangular(LmB.mH, y, upper=True)
    else:
        def minv(X, _k: int = 12):
            # fixed-k CG on SPD M (no convergence check: the filter
            # tolerates an inexact M-solve)
            def dot(P, Q):
                return (P.conj() * Q).sum(-2, keepdim=True)

            x = X
            r = X - M.mm(x)
            p = r
            rs = dot(r, r)
            for _ in range(_k):
                Mp = M.mm(p)
                alpha = rs / _nonzero(dot(p, Mp))
                x = x + alpha * p
                r = r - alpha * Mp
                rs_new = dot(r, r)
                p = r + (rs_new / _nonzero(rs)) * p
                rs = rs_new
            return x

    # accurate operator application (RR / residuals / bounds)
    def mm_hi(X):
        out = A.mm(X)
        return out if sign > 0 else -out

    if fast_filter and isinstance(A, MatrixLinearOperator) \
            and A.dtype == torch.float32:
        def mm_lo(X):
            prev = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("high")
            try:
                out = torch.matmul(A.mat, X)
            finally:
                torch.set_float32_matmul_precision(prev)
            return out if sign > 0 else -out
    else:
        mm_lo = mm_hi

    V0 = _set_initial_v(v_init.lower(), dtype, device, bcast_dims, na, block, M=M)

    def filt_op(X):
        # A for the standard problem, M^-1 A for the pencil (its
        # eigenvectors are the pencil's)
        return minv(mm_lo(X))

    def rayleigh_ritz(V):
        # V is M-orthonormal, so T = V^H A V gives pencil Ritz pairs
        AV = mm_hi(V)
        T = dot_hi(V.mH, AV)
        T = (T + T.mH) * 0.5
        ritz, W = _rr_eigh(T)  # ascending
        return dot_hi(V, W), dot_hi(AV, W), ritz

    def _mnorm(W):
        # M-norm per column (2-norm for the standard problem)
        return torch.sqrt((W.conj() * mmM(W)).sum(-2, keepdim=True).abs())

    # spectral upper bound: power iteration on M^-1 A plus a safety margin
    # (the filter just needs b >= lambda_max)
    pv = _randn(_generator(2310, device), (*bcast_dims, na, 1), dtype)
    pv = pv / _mnorm(pv)
    for _ in range(12):
        w = minv(mm_hi(pv))
        pv = w / _nonzero(_mnorm(w))
    Apv = mm_hi(pv)
    # pencil Rayleigh quotient (pv is M-normalised) + M-norm slack bounds
    # max |lambda| of the pencil
    lam_est = (pv.conj() * Apv).sum(-2, keepdim=True).real
    slack = _mnorm(minv(Apv) - lam_est.to(dtype) * pv)
    b_up = (lam_est.abs() + slack) * 1.01  # (*B, 1, 1) >= max |lambda|

    if min_eps is None:
        # scale-aware tolerance (the auto-routed default): sqrt(eps)*||A||.
        # Eigenvalue accuracy is quadratic in the residual, so this matches
        # the dense route's values in a few filter rounds; callers wanting
        # eps-grade eigenvector residuals pass min_eps.
        min_eps = math.sqrt(float(torch.finfo(b_up.dtype).eps)) * b_up.max()

    def cheb_filter(X, a, b, a0):
        """Scaled Chebyshev filter of fixed ``degree`` damping [a, b] and
        amplifying below a, normalised at a0 (three-term recurrence with
        sigma-scaling against overflow)."""
        e = (b - a) * 0.5
        c = (b + a) * 0.5
        e = torch.where(e <= 0, torch.ones_like(e), e)
        sigma1 = e / (a0 - c)
        sig = sigma1
        Xp = X
        Y = (filt_op(X) - c * X) * (sigma1 / e)
        for _ in range(1, degree):
            sig2 = 1.0 / (2.0 / sigma1 - sig)
            Yn = 2.0 * (filt_op(Y) - c * Y) * (sig2 / e) - (sig * sig2) * Xp
            Xp, Y, sig = Y, Yn, sig2
        return Y

    def _orthonormalize(Y):
        # normalise columns first (the filter amplifies each Ritz column at
        # a different rate), then Cholesky-QR twice: a single CholQR in
        # float32 loses orthogonality once cond(Y) > ~1/sqrt(eps)
        Y = Y / _nonzero(_colnorm(Y))
        V, _ = tallqr(Y, MV=mmM(Y) if M is not None else None)
        V, _ = tallqr(V, MV=mmM(V) if M is not None else None)
        return V

    def block_resid(X, AX, ritz):
        R = AX - mmM(X) * ritz[..., None, :]
        return _colnorm(R[..., :neig]).max()

    # initial RR on the random block seeds the cutoff; bounds are per batch
    # element (*B, 1, 1), so each gets its own filter window
    X, AX, ritz = rayleigh_ritz(V0)
    resid = block_resid(X, AX, ritz)
    best_ritz, best_X, best_resid = ritz, X, resid
    inf = torch.tensor(float("inf"), dtype=resid.dtype, device=device)
    niter = 0
    while niter < max_niter and bool(resid >= min_eps):
        # damping interval from the block's upper Ritz edge: everything
        # above it is damped, the block itself amplified
        a_cut = ritz[..., -1][..., None, None]
        a0_low = ritz[..., 0][..., None, None]
        V = _orthonormalize(cheb_filter(X, a_cut, b_up, a0_low))
        Xn, AXn, ritzn = rayleigh_ritz(V)
        resid_n = block_resid(Xn, AXn, ritzn)
        # a degenerate filter output (QR of a rank-deficient block): fall
        # back to the previous iterate
        valid = _finite(ritzn, Xn)
        X = torch.where(valid, Xn, X)
        ritz = torch.where(valid, ritzn, ritz)
        resid = torch.where(valid, resid_n, inf)
        better = resid < best_resid
        best_ritz = torch.where(better, ritz, best_ritz)
        best_X = torch.where(better, X, best_X)
        best_resid = torch.where(better, resid, best_resid)
        niter += 1

    # polish: LOBPCG-style rounds on [X, R] in IEEE float32, only while the
    # residual target is still missed
    k = 0
    while k < polish and bool(best_resid >= min_eps):
        AXb = mm_hi(best_X)
        R = AXb - mmM(best_X) * best_ritz[..., None, :]
        W = torch.cat([best_X, R / _nonzero(_colnorm(R))], dim=-1)[..., :na]
        Xn, AXn, ritzn = rayleigh_ritz(_orthonormalize(W))
        Xn, AXn, ritzn = Xn[..., :block], AXn[..., :block], ritzn[..., :block]
        resid_n = block_resid(Xn, AXn, ritzn)
        valid = _finite(ritzn, Xn) & (resid_n < best_resid)
        best_X = torch.where(valid, Xn, best_X)
        best_ritz = torch.where(valid, ritzn, best_ritz)
        best_resid = torch.where(valid, resid_n, best_resid)
        k += 1

    lam_out = best_ritz[..., :neig]
    X_out = best_X[..., :neig]
    if sign < 0:
        lam_out = -lam_out.flip(-1)
        X_out = X_out.flip(-1)
    if return_info:
        return lam_out, X_out, _iter_info(best_resid, min_eps, niter, device)
    return lam_out, X_out
