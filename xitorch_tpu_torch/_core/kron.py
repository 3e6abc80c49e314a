"""Kronecker-structured matrix-free operators with direct solve paths
(counterpart of xitorch_tpu/_core/kron.py).

Separable N-D problems (tensor-product grids, lattice models,
Sylvester/Lyapunov equations) factor as

* ``KronOperator(A1, ..., Ak)``    = A1 (x) ... (x) Ak
* ``KronSumOperator(A1, ..., Ak)`` = sum_i I (x)..(x) Ai (x)..(x) I
  (e.g. a 2-D/3-D Laplacian from 1-D ones)

Both apply as one batched matrix product per factor on the tensor-reshaped
input: O(N * sum_i n_i) operations per matvec in the full dimension
N = prod n_i instead of O(N^2).  For hermitian factors,
``linalg.solve(..., method="kron_direct")`` solves in the factor
eigenbases (the classic "fast Poisson" route): an eigendecomposition of
each small factor (on a CUDA float32 factor of 64 <= n <= 1024 the Jacobi
sweep kernel, ops/jacobi_eigh.py), one basis transform per axis, an
elementwise divide, and the transforms back.  O(sum n_i^3) instead of
O(N^3) dense.  ``symeig(method="kron_exact")`` returns exact eigenpairs the
same way.

The vec convention is ROW-major (``reshape``): for two factors,
``(A1 (x) A2) vec(X) = vec(A1 X A2^T)``.
"""
from __future__ import annotations

import functools
import math
from typing import List

import torch

from xitorch_tpu_torch._core.linop import LinearOperator
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["KronOperator", "KronSumOperator"]


def _prep_factor(A, i):
    if isinstance(A, LinearOperator):
        herm = A.is_hermitian
        mat = A.fullmatrix()
    else:
        mat = torch.as_tensor(A)
        herm = False
    if mat.dim() < 2 or mat.shape[-1] != mat.shape[-2]:
        raise RuntimeError(
            "Kron factor %d must be a square matrix (*B, n, n), got %s"
            % (i, tuple(mat.shape)))
    return mat, herm


def _kron2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched kron of (*B, p, p) and (*B, q, q) -> (*B, p*q, p*q)."""
    p, q = a.shape[-1], b.shape[-1]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(*out.shape[:-4], p * q, p * q)


class _KronBase(LinearOperator):
    def __init__(self, *factors, is_hermitian=None):
        if len(factors) < 2:
            raise RuntimeError(
                "%s needs at least two factors" % type(self).__name__)
        mats, herms = [], []
        for i, f in enumerate(factors):
            m, h = _prep_factor(f, i)
            mats.append(m)
            herms.append(h)
        # promote, never truncate: casting to the first factor's dtype
        # would silently drop imaginary parts or downcast float64
        dtype = functools.reduce(torch.promote_types, (m.dtype for m in mats))
        mats = [m.to(dtype) for m in mats]
        if is_hermitian is None:
            is_hermitian = all(herms)
        batch = torch.broadcast_shapes(*(m.shape[:-2] for m in mats))
        n = math.prod(m.shape[-1] for m in mats)
        super().__init__(shape=(*batch, n, n), is_hermitian=is_hermitian,
                         dtype=dtype, device=mats[0].device)
        self.factors = tuple(mats)
        self.dims = tuple(m.shape[-1] for m in mats)
        # 2-factor convenience aliases (Sylvester-style usage)
        self.n1 = self.dims[0]
        self.n2 = self.dims[-1]

    def _getparamnames(self, prefix: str = "") -> List[str]:
        # the tuple of factor tensors: getlinopparams returns its members
        return [prefix + "factors"]

    # --- tensor plumbing: apply a matrix along grid axis i of the
    # row-major flattened input; pre/post dims are flattened so one
    # einsum form serves every axis and any factor batch dims ---
    def _apply_axis(self, x, mat, i, extra=1):
        """x: (*Bx, N*extra) with N = prod(dims) and ``extra`` trailing
        columns folded in; applies ``mat`` along grid axis i, in IEEE
        float32 (never TF32): these products feed iterative solvers'
        residuals, as ``MatrixLinearOperator``'s do."""
        pre = math.prod(self.dims[:i])
        ni = self.dims[i]
        post = math.prod(self.dims[i + 1:]) * extra
        xr = x.reshape(*x.shape[:-1], pre, ni, post)
        dtype = torch.promote_types(mat.dtype, xr.dtype)
        yr = einsum_hi("...ij,...pjq->...piq", mat.to(dtype), xr.to(dtype))
        return yr.reshape(*yr.shape[:-3], pre * ni * post)

    def _apply(self, c, extra):
        """The operator on ``c (*B, N*extra)`` (see :meth:`_apply_axis`)."""
        raise NotImplementedError

    def _mv(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(x, 1)

    def _mm(self, x: torch.Tensor) -> torch.Tensor:
        # the columns ride along as trailing "extra" in every axis product
        N, ncols = x.shape[-2:]
        y = self._apply(x.reshape(*x.shape[:-2], N * ncols), ncols)
        return y.reshape(*y.shape[:-1], N, ncols)

    @staticmethod
    def _combine(a, b):
        """How per-factor eigenvalues merge into the full spectrum (sum
        for Kronecker sums, product for Kronecker products)."""
        raise NotImplementedError

    def combined_eigendecomposition(self):
        """Decompose every factor (degeneracy-safe) and return
        ``(eigenvalue grid (*B, n1, ..., nk), [V_i factor eigvecs])``
        where the grid entries are ``self._combine``-reduced over axes."""
        from xitorch_tpu_torch._impls.linalg.symeig import degen_eigh

        ls, Vs = [], []
        for m in self.factors:
            lam, V = degen_eigh((m + m.mH) * 0.5)
            ls.append(lam)
            Vs.append(V)
        batch = torch.broadcast_shapes(*(lam.shape[:-1] for lam in ls))
        k = len(self.dims)
        comb = None
        for i, lam in enumerate(ls):
            le = lam.reshape(*lam.shape[:-1], *(1,) * i, self.dims[i],
                             *(1,) * (k - 1 - i))
            comb = le if comb is None else self._combine(comb, le)
        return comb.expand(*batch, *self.dims), Vs


class KronOperator(_KronBase):
    r"""``A1 (x) A2 (x) ... (x) Ak`` as a matrix-free LinearOperator.

    Factors may be tensors or (explicit) LinearOperators; hermitian iff
    all factors are (or pass ``is_hermitian`` explicitly).  The matvec
    applies one matrix product per factor on the tensor-reshaped input.
    """

    @staticmethod
    def _combine(a, b):
        return a * b

    def _apply(self, c, extra):
        for i, m in enumerate(self.factors):
            c = self._apply_axis(c, m, i, extra)
        return c

    def _fullmatrix(self) -> torch.Tensor:
        batch = self.shape[:-2]
        out = self.factors[0].expand(*batch, self.dims[0], self.dims[0])
        for m, d in zip(self.factors[1:], self.dims[1:]):
            out = _kron2(out, m.expand(*batch, d, d))
        return out


class KronSumOperator(_KronBase):
    r"""Kronecker sum ``sum_i I (x) .. (x) A_i (x) .. (x) I`` (e.g. the
    N-D Laplacian built from 1-D ones).

    Eigenvalues are all sums ``sum_i lam_i[j_i]`` with eigenvectors
    ``v_1[j_1] (x) ... (x) v_k[j_k]``: ``linalg.solve(...,
    method="kron_direct")`` and ``symeig(..., method="kron_exact")``
    exploit this for hermitian factors.
    """

    @staticmethod
    def _combine(a, b):
        return a + b

    def _apply(self, c, extra):
        y = None
        for i, m in enumerate(self.factors):
            t = self._apply_axis(c, m, i, extra)
            y = t if y is None else y + t
        return y

    def _fullmatrix(self) -> torch.Tensor:
        batch = self.shape[:-2]
        out = None
        for i, (m, d) in enumerate(zip(self.factors, self.dims)):
            pre = math.prod(self.dims[:i])
            post = math.prod(self.dims[i + 1:])
            term = m.expand(*batch, d, d)
            if pre > 1:
                eye_p = torch.eye(pre, dtype=self.dtype, device=self.device)
                term = _kron2(eye_p.expand(*batch, pre, pre), term)
            if post > 1:
                eye_q = torch.eye(post, dtype=self.dtype, device=self.device)
                term = _kron2(term, eye_q.expand(*batch, post, post))
            out = term if out is None else out + term
        return out
