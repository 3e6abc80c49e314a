"""The DC-deflated warm panel behind ``jacobi_eigh(deflate=True)``
(counterpart of the reachable part of xitorch_tpu/ops/_finisher_lab.py).

The divide-and-conquer sort (``ops/dc_kernel.py``, two levels, with its
``T = Q^T A_shift Q``, segment ids and one re-projection pass) leaves four
nearly decoupled diagonal blocks.  Instead of warm-starting full-n sweeps,
:func:`deflated_panel` solves them with the sweep kernel at window size
(stage 1: one masked window per segment, cut at the segment's own start;
stage 2: small unmasked windows astride each segment boundary) and rotates
the panel by the results.  ``jacobi_eigh`` then runs its correction, its
guard and a finisher sweep, and :func:`deflate_refine` a Rayleigh-Ritz
rotation on the unshifted input.  The path is opt-in: the JAX package
measured it slower than its default, and on the card the DC kernel alone
takes longer than a cold call.

The JAX module's six rejected finisher prototypes are on no shipped path
and are not ported.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from xitorch_tpu_torch.ops.dc_kernel import dc_precondition
from xitorch_tpu_torch.ops.jacobi_eigh import _UNROLL, _eps_floor, jacobi_sweep
from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["deflated_panel", "deflate_refine"]

_REFINE_EMAX = 0.02  # gap clip for the unshifted Rayleigh refinement
# boundary-window half-width (stage 2): clusters up to 2 * 16 eigenvalues
# wide that a segment boundary cut are solved exactly; wider ones are left
# to the finisher
_BOUNDARY_HALF = 16


@functools.lru_cache(maxsize=None)
def _restore_perm_table(n: int, max_sweeps: int) -> np.ndarray:
    """Row-gather table undoing the tournament drift of the plain sweep.

    The Brent-Luk shuffle advances row contents one fixed permutation per
    round; its period is ``n - 1`` (slot 0 is pinned, the rest form one
    cycle), but a sweep runs ``ceil((n-1)/6)*6`` rounds, so after ``k``
    sweeps the rows sit at the ``k * rounds``-th power of that permutation.
    Entry ``[k, i]``: the slot holding original row ``i`` after ``k``
    sweeps.  (numpy, cached)"""
    h = n // 2
    rounds = -(-(n - 1) // _UNROLL) * _UNROLL
    table = np.zeros((max_sweeps + 1, n), np.int64)
    for k in range(max_sweeps + 1):
        track = np.arange(n)
        for _ in range((rounds * k) % (n - 1)):
            t, b = track[:h], track[h:]
            track = np.concatenate([t[0:1], b[0:1], t[1:h - 1], b[1:], t[h - 1:h]])
        # track[i] = original row now at slot i; invert for the gather
        inv = np.empty(n, np.int64)
        inv[track] = np.arange(n)
        table[k] = inv
    return table.astype(np.int32)


def _window_solve(blocks: torch.Tensor, *, max_sweeps: int,
                  sort_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Orthogonal rotations diagonalising (BB, w, w) symmetric blocks, rows
    = eigenvectors^T in their original slot order: a block row whose
    couplings are exactly zero (a pass-through slot) maps to exactly its
    own unit vector at its own slot.

    Steps: a Gershgorin shift per block, the sweep (each matrix its own
    sweep count), the restore of the tournament order where the route that
    ran moved the rows (the plain version; the kernel keeps the input's
    order: ``jacobi_sweep``'s ``drift``), row normalisation.

    ``sort_valid`` ((BB, w) bool): put the rows at valid slots in ascending
    order of eigenvalue among themselves (pass-through slots stay pinned):
    the boundary windows find a split near-degenerate pair only if each
    segment's solved rows sit in spectral order."""
    BB, w, _ = blocks.shape
    dt = blocks.dtype
    tol = float(torch.finfo(dt).eps) * 4.0 * math.sqrt(w)
    absb = blocks.abs()
    diag = torch.diagonal(blocks, dim1=-2, dim2=-1)
    offsum = absb.sum(-1) - torch.diagonal(absb, dim1=-2, dim2=-1)
    lower = (diag - offsum).amin(-1)
    frob = torch.sqrt((absb * absb).sum(dim=(-2, -1)))
    sigma = torch.clamp(-lower, min=0.0) + 0.01 * frob + 1e-30
    shifted = blocks + sigma[:, None, None] * torch.eye(w, dtype=dt, device=blocks.device)
    gt, _, drift = jacobi_sweep(shifted, max_sweeps, tol, return_drift=True)
    table = torch.as_tensor(_restore_perm_table(w, max_sweeps), device=blocks.device)
    fix = table[drift.long()].long()                           # (BB, w)
    gt = torch.take_along_dim(gt, fix[:, :, None], dim=1)
    nrm = torch.sqrt((gt * gt).sum(-1, keepdim=True))
    R = gt / torch.clamp(nrm, min=_eps_floor(dt))
    if sort_valid is not None:
        slot = torch.arange(w, device=blocks.device)[None, :]
        lam = nrm[:, :, 0]                    # lambda + sigma, monotone
        # rows by ascending eigenvalue among the valid ones, then the
        # pass-through rows in slot order (stable on equal +inf keys)
        ord_v = torch.argsort(torch.where(sort_valid, lam, math.inf), dim=-1, stable=True)
        # target slots: valid slots ascending, then pass-through slots
        # ascending, so that each pass-through row keeps its own slot
        vpos = torch.argsort(torch.where(sort_valid, slot, w + slot), dim=-1, stable=True)
        gather = torch.empty_like(ord_v).scatter_(1, vpos, ord_v)
        R = torch.take_along_dim(R, gather[:, :, None], dim=1)
    return R


def _window_index(starts: torch.Tensor, w: int) -> torch.Tensor:
    """(B, w) row indices of the windows of width w at ``starts`` (B,)."""
    return starts[:, None] + torch.arange(w, device=starts.device)


def _take_block(T: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The (B, w, w) diagonal blocks ``T[b][idx[b]][:, idx[b]]``."""
    B, n, _ = T.shape
    w = idx.shape[-1]
    rows = torch.take_along_dim(T, idx[:, :, None].expand(B, w, n), dim=1)
    return torch.take_along_dim(rows, idx[:, None, :].expand(B, w, w), dim=2)


def _apply_rows(P: torch.Tensor, R: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``P`` with its rows ``idx`` replaced by ``R @ P[idx]``."""
    B, w = idx.shape
    ix = idx[:, :, None].expand(B, w, P.shape[-1])
    return P.scatter(1, ix, dot_hi(R, torch.take_along_dim(P, ix, dim=1)))


def _apply_cols(T: torch.Tensor, R: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``T`` with its columns ``idx`` replaced by ``T[:, idx] @ R^T``."""
    B, w = idx.shape
    ix = idx[:, None, :].expand(B, T.shape[-2], w)
    return T.scatter(2, ix, dot_hi(torch.take_along_dim(T, ix, dim=2), R.mT))


def deflated_panel(a_shift: torch.Tensor, *, max_sweeps: int,
                   levels: int = 2) -> torch.Tensor:
    """DC-deflated warm panel of a real (B, n, n) shifted batch: the
    divide-and-conquer sort (``refine=1``), then the sweep *solves* the
    decoupled diagonal blocks of the exact ``T = Q^T A_shift Q`` at window
    size instead of warm-starting full-n sweeps.

    Stage 1 solves one masked window a DC segment, cut at the segment's own
    start (the boundaries drift with the median splits), its out-of-segment
    slots masked to pass-through.  Stage 2 solves 32-wide unmasked windows
    astride each segment boundary, on the stage-1-conjugated T.  What is
    left (well-gapped far pairs, clusters wider than a boundary window)
    goes to the correction and the finisher sweep, which certifies
    convergence either way.

    ``levels`` 2: four segments balance the window cost against the DC
    depth."""
    B, n, _ = a_shift.shape
    ns = 2 ** levels
    dt = a_shift.dtype
    g0, T, seg = dc_precondition(a_shift, levels=levels, min_seg=2, return_t=True,
                                 return_seg=True, refine=1)
    seg = seg[:, :, 0]                                         # (B, n) int32
    # window = 1.5x the nominal segment size, 16-aligned: it covers the
    # median splits' drift; an overflowing tail is left to the finisher
    w = min(n, max(32, -(-3 * n // (2 * ns * 16)) * 16))
    starts = torch.stack([torch.clamp((seg < s).sum(-1), 0, n - w) for s in range(ns)],
                         dim=1)                                # (B, ns)
    idx = [_window_index(starts[:, s], w) for s in range(ns)]

    # pass-through slots: exactly zero couplings and a positive diagonal
    # (its value is irrelevant: they never rotate)
    passdiag = 1.0 + torch.arange(w, dtype=dt, device=a_shift.device)
    blocks, valid = [], []
    for s in range(ns):
        v = torch.take_along_dim(seg, idx[s], dim=1) == s      # (B, w)
        vv = v[:, :, None] & v[:, None, :]
        blk = torch.where(vv, _take_block(T, idx[s]), 0.0)
        blocks.append(blk + torch.diag_embed(torch.where(v, 0.0, passdiag)))
        valid.append(v)
    R = _window_solve(torch.stack(blocks, dim=1).reshape(B * ns, w, w),
                      max_sweeps=max_sweeps,
                      sort_valid=torch.stack(valid, dim=1).reshape(B * ns, w)
                      ).reshape(B, ns, w, w)
    # stage-1 rotations are the identity outside their own segment, so the
    # (possibly overlapping) window applications commute exactly
    for s in range(ns):
        g0 = _apply_rows(g0, R[:, s], idx[s])
        T = _apply_cols(_apply_rows(T, R[:, s], idx[s]), R[:, s], idx[s])

    # stage 2: overlapping boundary windows (segments narrower than the
    # window) rotate a stale block, still orthogonally: sweeps, at worst
    bw = 2 * _BOUNDARY_HALF
    if n > bw:
        bstarts = torch.clamp(starts[:, 1:] - _BOUNDARY_HALF, 0, n - bw)
        bidx = [_window_index(bstarts[:, s], bw) for s in range(ns - 1)]
        bblocks = torch.stack([_take_block(T, bidx[s]) for s in range(ns - 1)], dim=1)
        Rb = _window_solve(bblocks.reshape(B * (ns - 1), bw, bw),
                           max_sweeps=max_sweeps).reshape(B, ns - 1, bw, bw)
        for s in range(ns - 1):
            g0 = _apply_rows(g0, Rb[:, s], bidx[s])
    return g0


def deflate_refine(a0: torch.Tensor, V: torch.Tensor, AV: torch.Tensor,
                   lam: torch.Tensor):
    """Post-polish Rayleigh-Ritz rotation on the unshifted input for the
    deflated path.  The sweep's gauge certifies pair cosines in the
    shifted-squared metric, where the Gershgorin margin inflates
    mid-spectrum relative gaps; the deflated panel enters the finisher just
    under its tolerance and leaves at that floor.  One gap-clipped
    first-order rotation against ``H = V^T A V`` (the unshifted gaps) brings
    the residual back to the float32 floor; near-degenerate pairs are
    clipped (mixing within a cluster shares the eigenvalue).  Returns the
    refined ``(lam, V)`` unsorted."""
    dt = V.dtype
    eye = torch.eye(V.shape[-1], dtype=dt, device=V.device)
    H = dot_hi(V.mT, AV)
    denom = lam[..., None, :] - lam[..., :, None]
    # tighter clip than jacobi_eigh._ROT_EMAX: on the unshifted gaps the
    # field near clusters is dense enough that 0.1 lets ||E||_2 reach O(1)
    live = (H.abs() <= _REFINE_EMAX * denom.abs()) & (denom.abs() > _eps_floor(dt))
    E = torch.where(live, H / torch.where(live, denom, torch.ones_like(denom)),
                    torch.zeros_like(H))
    R = eye + E
    for _ in range(3):
        R = dot_hi(R, 1.5 * eye - 0.5 * dot_hi(R.mT, R))
    V = dot_hi(V, R)
    V = dot_hi(V, 1.5 * eye - 0.5 * dot_hi(V.mT, V))
    AV = dot_hi(a0, V)
    lam = (V.conj() * AV).sum(-2).real
    return lam, V
