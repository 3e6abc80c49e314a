"""Spectral divide-and-conquer preconditioner for the Jacobi eigh sweep
(counterpart of xitorch_tpu/ops/spectral_dc.py).

The one-sided Jacobi sweep (``ops/jacobi_eigh.py``) spends ~9 sweeps on a
random dense symmetric matrix.  This module computes an orthonormal basis
``Q`` such that ``Q^T A Q`` is nearly block-diagonal with small, roughly
eigenvalue-sorted blocks; warm-started on ``G0 = Q^T (A + sigma I)`` the
sweep needs fewer sweeps.  The preconditioner only has to be roughly
right: the Jacobi finisher bears the accuracy and converges from any
input, so soft projectors, rank miscounts and leaked couplings cost
finisher sweeps, never correctness.

The algorithm is matrix products only (no Cholesky, no triangular solve,
no sort):

* ``sign(X)`` and the polar orthonormalisation both run the quintic
  Newton-Schulz schedule ``x <- a x + b x^3 + c x^5`` with
  ``(a, b, c) = (3.4445, -4.7750, 2.0315)`` followed by cubic polish
  steps; inputs are pre-scaled by a segmented 1-norm bound so the
  spectrum starts inside [0, 1];
* per-segment medians, ranks and sizes come from comparison matrices and
  masked reductions;
* each level splits every segment in two around the median of its
  diagonal; segment membership, split ranks and shifts are values, so a
  batch carries one split topology per matrix.

This file is the plain batched PyTorch statement of the algorithm (every
product through ``dot_hi``, IEEE float32) and the oracle of the kernel's
tests: it symmetrises and masks ``T`` at every step, which the fused
kernel (``ops/dc_kernel.py``, ``csrc/dc_kernel.cu``) does not, so the two
agree to a tolerance, not to rounding.  The level loop:

1. ``sigma_s`` = per-segment median of ``diag(T)``;
2. ``E ~ sign(T - Sigma)`` by Newton-Schulz on the segment-scaled matrix;
   ``P = (I - E)/2`` soft-projects onto the below-median subspaces;
3. slot assignment: the first ``r_s = round(trace_s P)`` positions of each
   segment take columns ``P omega_j``, the rest ``(I - P) omega_j``
   (``omega``: a fixed random mixer, segment-masked); a Newton-Schulz
   polar step orthonormalises the result into ``Q_level``;
4. ``T <- Q^T T Q`` masked back to block-diagonal, ``Q_tot <- Q_tot Q``,
   segment ids split.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["spectral_sort_basis", "dc_precondition", "default_probe"]

# quintic Newton-Schulz coefficients (the Muon/polar-express ones), used for
# both the sign and the polar iteration.  8 quintic + 3 cubic steps map
# [8e-5, 1] to 1 +- 1e-3 with intermediate values bounded by 1.21; the ramp
# length sets the halfwidth of the band of eigenvalues around the split
# that stay soft and leak cross-block coupling.
_QUINTIC = (3.4445, -4.7750, 2.0315)
_N_QUINTIC = 8
# rank-safety probe blend for the slot split (see the Y construction in
# _dc_level); shared by the fused kernel
_RANK_SAFE_BETA = 0.002
_N_CUBIC = 3

_PROBE_SEED = 1803


def default_probe(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The fixed (n, n) standard-normal mixer ``omega``: drawn on the CPU
    from a ``torch.Generator`` seeded 1803 (in float64, then cast) and moved
    to ``device``, so every device and every implementation sees the same
    probe.  Drawn once per (n, dtype, device) and shared: callers only read
    it (at 768^2 a draw and its copy to the card cost ~18 ms a call)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _probe(n, dtype, device)


@functools.lru_cache(maxsize=64)
def _probe(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(_PROBE_SEED)
    om = torch.randn((n, n), generator=gen, dtype=torch.float64)
    return om.to(dtype=dtype, device=device)


def as_probe(om, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``om`` (None, a tensor or a numpy array) as an (n, n) tensor of the
    given dtype on the given device."""
    if om is None:
        return default_probe(n, dtype, device)
    if not torch.is_tensor(om):
        om = torch.from_numpy(np.array(om))
    if tuple(om.shape) != (n, n):
        raise ValueError("the probe must be (%d, %d), got %s" % (n, n, tuple(om.shape)))
    return om.to(dtype=dtype, device=device).contiguous()


def _msign(X: torch.Tensor, blockmask: torch.Tensor) -> torch.Tensor:
    """sign(X) for symmetric X with spectrum in [-1, 1], products only.
    ``blockmask`` re-zeroes the cross-segment entries at every step (they
    are zero in exact arithmetic)."""
    a, b, c = _QUINTIC
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    for _ in range(_N_QUINTIC):
        X2 = dot_hi(X, X)
        X4 = dot_hi(X2, X2)
        X = dot_hi(X, a * eye + b * X2 + c * X4)
        X = 0.5 * (X + X.mT) * blockmask
    for _ in range(_N_CUBIC):
        X2 = dot_hi(X, X)
        X = 1.5 * X - 0.5 * dot_hi(X, X2)
        X = 0.5 * (X + X.mT) * blockmask
    return X


_N_QUINTIC_POLAR = 10   # covers the small-sigma_min tail of random blocks
_N_CUBIC_POLAR = 5


def _polar_orth(Y: torch.Tensor) -> torch.Tensor:
    """Orthogonal polar factor of Y (square, sigma <= 1 after the caller's
    scaling), products only: quintic ramp, then cubic polish."""
    a, b, c = _QUINTIC
    eye = torch.eye(Y.shape[-1], dtype=Y.dtype, device=Y.device)
    Q = Y
    for _ in range(_N_QUINTIC_POLAR):
        G = dot_hi(Q.mT, Q)
        G2 = dot_hi(G, G)
        Q = dot_hi(Q, a * eye + b * G + c * G2)
    for _ in range(_N_CUBIC_POLAR):
        G = dot_hi(Q.mT, Q)
        Q = 1.5 * Q - 0.5 * dot_hi(Q, G)
    return Q


def _seg_reduce(x: torch.Tensor, seg_eq: torch.Tensor) -> torch.Tensor:
    """Per-position segment sum of x: (B, n) -> (B, n) through the
    (B, n, n) membership mask."""
    return (seg_eq * x[:, None, :]).sum(-1)


def _seg_median(d: torch.Tensor, seg_eq: torch.Tensor, sizes: torch.Tensor
                ) -> torch.Tensor:
    """Per-position median of d over its segment by comparison-matrix
    ranking: ``rank_i = #{j in seg(i): (d_j, j) < (d_i, i)}``; the median
    is the value whose rank equals the middle target."""
    n = d.shape[-1]
    lt = d[:, None, :] < d[:, :, None]
    iot = torch.arange(n, device=d.device)
    tie = (d[:, None, :] == d[:, :, None]) & (iot[None, None, :] < iot[None, :, None])
    rank = (seg_eq * (lt | tie)).sum(-1).to(torch.int64)            # (B, n)
    lo_t = torch.div(sizes - 1, 2, rounding_mode="floor")
    hi_t = torch.div(sizes, 2, rounding_mode="floor")
    # value with rank == target, summed over the segment (exactly one hit)
    is_lo = seg_eq * (rank[:, None, :] == lo_t[:, :, None])
    is_hi = seg_eq * (rank[:, None, :] == hi_t[:, :, None])
    lo = (is_lo * d[:, None, :]).sum(-1)
    hi = (is_hi * d[:, None, :]).sum(-1)
    return 0.5 * (lo + hi)


def _dc_level(T, Qtot, seg, om, min_seg: int):
    """One divide level on (B, n, n) state; returns the updated
    ``(T, Qtot, seg)``."""
    n = T.shape[-1]
    dt = T.dtype
    eye = torch.eye(n, dtype=dt, device=T.device)
    iot = torch.arange(n, device=T.device)
    seg_eq_b = seg[:, :, None] == seg[:, None, :]
    seg_eq = seg_eq_b.to(dt)
    starts = (seg[:, None, :] < seg[:, :, None]).sum(-1)
    sizes = seg_eq_b.sum(-1)
    frozen = sizes <= min_seg
    fro_any = frozen[:, :, None] | frozen[:, None, :]
    live = (~fro_any).to(dt)

    d = torch.diagonal(T, dim1=-2, dim2=-1)
    sigma = _seg_median(d, seg_eq, sizes)
    C = (T - sigma[:, :, None] * eye) * seg_eq
    # segmented row-1-norm bound on the block spectral radius: strict
    # pre-scaling into [0, 1] (the quintic diverges above ~1.2)
    row1 = C.abs().sum(-1)
    bound = torch.where(seg_eq_b, row1[:, None, :], torch.zeros_like(C)).amax(-1)
    X = C / (1.01 * bound[:, :, None] + 1e-30)

    E = _msign(X, seg_eq * live)
    P = 0.5 * (eye * seg_eq - E) * live

    pdiag = torch.diagonal(P, dim1=-2, dim2=-1)
    r = torch.round(_seg_reduce(pdiag, seg_eq)).to(torch.int64)
    r = torch.minimum(torch.clamp(r, min=0), sizes)
    local = iot[None, :] - starts
    low = (local < r) & ~frozen

    omb = torch.where(fro_any, eye, om[None]) * seg_eq
    POm = dot_hi(P, omb)
    # rank-safety blend: when a soft projector's trace rounds to the wrong
    # rank, the hard slot split leaves more low (or high) columns than
    # range(P) (or its complement) has dimensions; the block goes
    # rank-deficient and the polar ramp cannot restore orthogonality.
    # Mixing beta of the raw probe back in makes Y full-rank almost surely,
    # at an O(beta) subspace-alignment cost the finisher sweeps away.
    Y = ((1.0 - _RANK_SAFE_BETA) * torch.where(low[:, None, :], POm, omb - POm)
         + _RANK_SAFE_BETA * omb)
    # scale into sigma <= 1 for the polar ramp: column-normalise, then a
    # segmented Schur bound ||Y_s||_2 <= sqrt(||Y_s||_1 ||Y_s||_inf)
    coln = torch.sqrt((Y * Y).sum(-2, keepdim=True))
    Y = Y / (coln + 1e-20)
    rsum = Y.abs().sum(-1)                                   # row 1-norms
    csum = Y.abs().sum(-2)                                   # column 1-norms
    zero = torch.zeros_like(C)
    rmax = torch.where(seg_eq_b, rsum[:, None, :], zero).amax(-1)
    cmax = torch.where(seg_eq_b, csum[:, None, :], zero).amax(-1)
    Y = Y / (1.01 * torch.sqrt(rmax * cmax)[:, :, None] + 1e-30)
    Q = _polar_orth(Y)

    T = dot_hi(Q.mT, dot_hi(T, Q))
    T = 0.5 * (T + T.mT) * seg_eq
    Qtot = dot_hi(Qtot, Q)
    seg = seg * 2 + torch.where(low | frozen, 0, 1)
    return T, Qtot, seg


def spectral_sort_basis(A: torch.Tensor, *, levels: int = 5, min_seg: int = 4,
                        om: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Orthonormal ``Q`` (B, n, n) with ``Q^T A Q`` near block-diagonal in
    ~``n / 2**levels``-sized, eigenvalue-sorted segments.

    ``A``: (B, n, n) real symmetric.  ``om``: the (n, n) mixer (a tensor or
    numpy array); ``None`` draws :func:`default_probe`.
    """
    B, n, _ = A.shape
    dt = A.dtype
    om = as_probe(om, n, dt, A.device)
    T = 0.5 * (A + A.mT)
    Qtot = torch.eye(n, dtype=dt, device=A.device).expand(B, n, n)
    seg = torch.zeros((B, n), dtype=torch.int64, device=A.device)
    for _ in range(levels):
        T, Qtot, seg = _dc_level(T, Qtot, seg, om, min_seg)
    return Qtot


def dc_precondition(a_shift: torch.Tensor, *, levels: int = 5, min_seg: int = 4,
                    om: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``G0 = Q^T a_shift`` with Q from the spectral sort: the warm-start
    panel of the one-sided Jacobi sweep (its rows are ``q_i^T A_shift``).
    Plain composition; the fused counterpart is
    ``ops.dc_kernel.dc_precondition``."""
    Q = spectral_sort_basis(a_shift, levels=levels, min_seg=min_seg, om=om)
    return dot_hi(Q.mT, a_shift)
