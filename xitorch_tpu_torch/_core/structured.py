"""Structured matrix-free operators with fused solve paths (counterpart of
xitorch_tpu/_core/structured.py).

A declared structure (diagonal + bands + low rank) lets
``linalg.solve(..., method="structured_cg")`` dispatch to a CUDA kernel
that keeps the whole CG state and the operator data in shared memory
(xitorch_tpu_torch/ops/structured_cg.py), or to the direct Thomas kernel
for a pure tridiagonal operator (xitorch_tpu_torch/ops/tridiag.py).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from xitorch_tpu_torch._core.linop import LinearOperator
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["TridiagLowRankOperator", "BandedLowRankOperator"]


def _reject_complex(d: torch.Tensor, name: str) -> None:
    # the declared structure mirrors bands unconjugated and applies
    # V V^T (not V V^H), which is complex-*symmetric*, not hermitian —
    # cg/minres would silently treat it as hermitian and return wrong
    # results (the fused CG kernel is f32-only anyway)
    if d.is_complex():
        raise RuntimeError(
            "%s requires a real dtype (got %s): the structure applies "
            "V V^T and mirrors bands unconjugated, which is not hermitian "
            "for complex data" % (name, d.dtype))


def _like(a, d: torch.Tensor) -> torch.Tensor:
    # keeps the caller's tensor (and its autograd identity) when it already
    # has d's dtype and device
    return torch.as_tensor(a, dtype=d.dtype, device=d.device)


def _lowrank_mv(V: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # IEEE f32: this matvec feeds the fallback CG's residuals
    vtx = einsum_hi("...nk,...n->...k", V, x)
    return einsum_hi("...nk,...k->...n", V, vtx)


class BandedLowRankOperator(LinearOperator):
    r"""Hermitian operator :math:`A = \mathrm{diag}(d) + \sum_k B_{o_k}(c_k)
    + V V^T` with symmetric bands at arbitrary offsets.

    ``d``: (*B, n) diagonal; ``bands``: mapping ``{offset: coupling}`` with
    offset >= 1 and coupling scalar or (*B, n-offset) (``c[..., i]``
    couples sites i and i+offset, mirrored below the diagonal); ``V``:
    optional (*B, n, r) low-rank factor.
    """

    def __init__(self, d: torch.Tensor, bands=None,
                 V: Optional[torch.Tensor] = None):
        d = torch.as_tensor(d)
        _reject_complex(d, "BandedLowRankOperator")
        n = d.shape[-1]
        bands = dict(bands or {})
        offsets = tuple(sorted(int(o) for o in bands))
        if any(o < 1 or o >= n for o in offsets):
            raise RuntimeError(
                "BandedLowRankOperator: band offsets must be in [1, n-1]"
                " (got %s with n=%d)" % (offsets, n))
        vals = []
        batch = tuple(d.shape[:-1])
        for o in offsets:
            c = _like(bands[o], d)
            if c.ndim > 0 and c.shape[-1] != n - o:
                raise RuntimeError(
                    "BandedLowRankOperator: band %d coupling must be a "
                    "scalar or have last dim n-%d=%d (got %s)"
                    % (o, o, n - o, tuple(c.shape)))
            if c.ndim > 1:
                batch = torch.broadcast_shapes(batch, c.shape[:-1])
            vals.append(c)
        if V is not None:
            V = _like(V, d)
            if V.shape[-2] != n:
                raise RuntimeError(
                    "BandedLowRankOperator: V must be (*B, n=%d, r) "
                    "(got %s)" % (n, tuple(V.shape)))
            batch = torch.broadcast_shapes(batch, V.shape[:-2])
        super().__init__(shape=(*batch, n, n), is_hermitian=True,
                         dtype=d.dtype, device=d.device)
        self.d = d
        self.offsets = offsets
        self.band_vals = tuple(vals)
        self.V = V

    def _getparamnames(self, prefix: str = "") -> List[str]:
        names = [prefix + "d"]
        names += [prefix + "band_vals[%d]" % i for i in range(len(self.band_vals))]
        if self.V is not None:
            names.append(prefix + "V")
        return names

    def _mv(self, x: torch.Tensor) -> torch.Tensor:
        y = self.d * x
        for o, c in zip(self.offsets, self.band_vals):
            y = y + F.pad(c * x[..., o:], (0, o))
            y = y + F.pad(c * x[..., :-o], (o, 0))
        if self.V is not None:
            y = y + _lowrank_mv(self.V, x)
        return y

    def _fullmatrix(self) -> torch.Tensor:
        n = self.shape[-1]
        batch = self.shape[:-2]
        out = torch.zeros((*batch, n, n), dtype=self.dtype, device=self.device) \
            + torch.diag_embed(self.d)
        for o, c in zip(self.offsets, self.band_vals):
            cb = c.expand(*batch, n - o)
            out = out + torch.diag_embed(cb, offset=o) + torch.diag_embed(cb, offset=-o)
        if self.V is not None:
            out = out + einsum_hi("...nk,...mk->...nm", self.V, self.V)
        return out

    def full_bands(self):
        """(bl, bu) as (*B, nb, n) planes with bl[..., k, :o_k] =
        bu[..., k, n-o_k:] = 0, the layout the CG kernel consumes."""
        n = self.shape[-1]
        batch = self.shape[:-2]
        bls, bus = [], []
        for o, c in zip(self.offsets, self.band_vals):
            cb = c.expand(*batch, n - o)
            zero = torch.zeros((*batch, o), dtype=self.dtype, device=self.device)
            bls.append(torch.cat([zero, cb], dim=-1))
            bus.append(torch.cat([cb, zero], dim=-1))
        return torch.stack(bls, dim=-2), torch.stack(bus, dim=-2)


class TridiagLowRankOperator(LinearOperator):
    r"""Hermitian operator :math:`A = \mathrm{diag}(d) + T(c) + V V^T`.

    ``d``: (*B, n) diagonal; ``c``: symmetric nearest-neighbour coupling,
    scalar or (*B, n-1) (``c[..., i]`` couples sites i and i+1); ``V``:
    optional (*B, n, r) low-rank factor (the BASELINE config-3 operator).

    ``linalg.solve(A, B, method="structured_cg")`` runs the fused CG kernel
    for this operator on CUDA float32 tensors; every other method treats
    it as a regular matrix-free LinearOperator via ``_mv``.
    """

    def __init__(self, d: torch.Tensor, c=None, V: Optional[torch.Tensor] = None):
        d = torch.as_tensor(d)
        _reject_complex(d, "TridiagLowRankOperator")
        n = d.shape[-1]
        if c is None:
            c = torch.zeros((0,), dtype=d.dtype, device=d.device)  # no coupling
        c = _like(c, d)
        if c.ndim > 0 and c.shape[-1] not in (0, n - 1):
            raise RuntimeError(
                "TridiagLowRankOperator: c must be a scalar or have last "
                "dim n-1=%d (got %s)" % (n - 1, tuple(c.shape)))
        batch = tuple(d.shape[:-1])
        if V is not None:
            V = _like(V, d)
            if V.shape[-2] != n:
                raise RuntimeError(
                    "TridiagLowRankOperator: V must be (*B, n=%d, r) "
                    "(got %s)" % (n, tuple(V.shape)))
            batch = torch.broadcast_shapes(batch, V.shape[:-2])
        if c.ndim > 1:
            batch = torch.broadcast_shapes(batch, c.shape[:-1])
        super().__init__(shape=(*batch, n, n), is_hermitian=True,
                         dtype=d.dtype, device=d.device)
        self.d = d
        self.c = c
        self.V = V

    def _getparamnames(self, prefix: str = "") -> List[str]:
        names = [prefix + "d", prefix + "c"]
        if self.V is not None:
            names.append(prefix + "V")
        return names

    @property
    def has_coupling(self) -> bool:
        return self.c.ndim == 0 or self.c.shape[-1] != 0

    def _mv(self, x: torch.Tensor) -> torch.Tensor:
        y = self.d * x
        if self.has_coupling:
            y = y + F.pad(self.c * x[..., 1:], (0, 1))
            y = y + F.pad(self.c * x[..., :-1], (1, 0))
        if self.V is not None:
            y = y + _lowrank_mv(self.V, x)
        return y

    def _fullmatrix(self) -> torch.Tensor:
        n = self.shape[-1]
        batch = self.shape[:-2]
        out = torch.zeros((*batch, n, n), dtype=self.dtype, device=self.device) \
            + torch.diag_embed(self.d)
        if self.has_coupling:
            c = self.c.expand(*batch, n - 1)
            out = out + torch.diag_embed(c, offset=1) + torch.diag_embed(c, offset=-1)
        if self.V is not None:
            out = out + einsum_hi("...nk,...mk->...nm", self.V, self.V)
        return out

    def full_couplings(self):
        """(cl, cu) as full-length (*B, n) tensors with cl[..., 0] =
        cu[..., -1] = 0, the layout the kernels consume."""
        n = self.shape[-1]
        batch = self.shape[:-2]
        if not self.has_coupling:
            z = torch.zeros((*batch, n), dtype=self.dtype, device=self.device)
            return z, z
        c = self.c.expand(*batch, n - 1)
        zero = torch.zeros((*batch, 1), dtype=self.dtype, device=self.device)
        cl = torch.cat([zero, c], dim=-1)   # couples to i-1
        cu = torch.cat([c, zero], dim=-1)   # couples to i+1
        return cl, cu
