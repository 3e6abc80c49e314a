"""Fused spectral divide-and-conquer warm start for the Jacobi eigh sweep
(counterpart of the single-shot part of xitorch_tpu/ops/dc_kernel.py).

Semantics and algorithm: ``ops/spectral_dc.py`` (per-segment median split,
Newton-Schulz matrix sign, slot assignment with the rank-safety blend,
Newton-Schulz polar orthonormalisation, ``T <- Q^T T Q``).  The fused
version runs the whole level recursion in one call and differs from the
plain statement of the algorithm in its bookkeeping: the
``T`` carry is never masked between levels (every use inside a level
applies the segment mask), the sign iteration is symmetrised once at its
end instead of at every step, and the warm panel ``G0 <- Q^T G0`` is
accumulated level by level instead of a total ``Q``.

* :func:`dc_precondition_cuda` launches the hand-written kernel sequence
  ``csrc/dc_kernel.cu`` on a CUDA tensor (all the levels put on the stream
  at once: segment bookkeeping one block a matrix, plane-wide passes, and
  each of a level's 74 products one batched IEEE float32 kernel over 32 x
  32 output tiles x matrices, k only over the ranges where the operands'
  segments can be nonzero; planes in a workspace in device memory) and
  counts one launch a call;
* :func:`dc_precondition_plain` is the kernel's own arithmetic, step by
  step, in batched PyTorch, with its products dense or (``tile``) over the
  kernel's k-ranges;
* :func:`dc_precondition` dispatches: the kernel for a CUDA tensor (or an
  error), the plain version for a CPU tensor.

Output: ``G0 = Q_tot^T a``, the warm-start row panel of the sweep (rows
are ``q_i^T a``, so the sweep's eigenvector extraction is unchanged).

For padded n above 448 :func:`dc_precondition` runs the per-level variant
of ``ops/dc_level.py`` instead (one launch a level, ``per_level``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from xitorch_tpu_torch.ops import _build, dc_level
from xitorch_tpu_torch.ops.spectral_dc import _QUINTIC, _RANK_SAFE_BETA, as_probe
from xitorch_tpu_torch.ops.tridiag import check_device

__all__ = ["dc_precondition", "dc_precondition_cuda", "dc_precondition_plain",
           "fits_dc_kernel"]

_N_QUINTIC_SIGN = 8    # ramp length = sharpness of the sign transition
_N_CUBIC_SIGN = 3      # contraction steps (the reference's 2 fast + 1 exact;
# on this card every product is IEEE float32, so they are one schedule)
_N_QUINTIC_POLAR = 10
_N_CUBIC_POLAR = 5     # the reference's 3 fast + 2 exact polish steps
_N_CUBIC_REFINE = 3
# sign, probe, polar, and T Q, Q^T (T Q), Q^T G0: 74
_PRODUCTS_PER_LEVEL = (3 * _N_QUINTIC_SIGN + 2 * _N_CUBIC_SIGN + 1
                       + 3 * _N_QUINTIC_POLAR + 2 * _N_CUBIC_POLAR + 3)

# Window of the kernel on the H100.  n: the segment bookkeeping is static
# shared-memory vectors of _N_MAX entries (kMaxN in csrc/dc_kernel.cu).
# levels: segment ids reach 2**levels in an int32.  B: the products' grid
# runs the batch along its third axis (at most 65,535).  Workspace: six
# (n, n) float32 planes a matrix in device memory (T and five scratch
# planes), bounded here so that a call cannot take the card's memory by
# surprise: 64 matrices of 256 x 256 need 100 MB, 64 of 1024 x 1024 1.6 GB.
_N_MAX = 1024
_LEVELS_MAX = 24
_B_MAX = 65535
_WORK_PLANES = 6
_WORK_BUDGET = 8 << 30
# the kernel's int and float vectors a matrix (kIvec, kFvec)
_IVEC, _FVEC = 6, 5
# rows of an output tile of the kernel's products: the width of a band
_TILE = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dc_precondition_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def fits_dc_kernel(B: int, n: int, levels: int, dtype) -> bool:
    """Whether a (B, n, n) batch lies in the kernel's window: float32,
    1 <= B <= 65535, 1 <= n <= 1024, 0 <= levels <= 24, workspace of at
    most 8 GiB."""
    return bool(dtype == torch.float32 and 1 <= B <= _B_MAX and 1 <= n <= _N_MAX
                and 0 <= levels <= _LEVELS_MAX
                and B * _WORK_PLANES * n * n * 4 <= _WORK_BUDGET)


def _check_input(a: torch.Tensor, what: str) -> None:
    if a.dim() != 3 or a.shape[-1] != a.shape[-2] or a.is_complex():
        raise RuntimeError("%s expects a real (B, n, n) batch, got %s %s"
                           % (what, a.dtype, tuple(a.shape)))


def _outputs(g, t, seg, return_t: bool, return_seg: bool):
    out = (g,) + ((t,) if return_t else ()) + ((seg,) if return_seg else ())
    return out if len(out) > 1 else g


def dc_precondition_plain(a: torch.Tensor, *, levels: int = 8, min_seg: int = 2,
                          return_t: bool = False, return_seg: bool = False,
                          refine: int = 0, om: Optional[torch.Tensor] = None,
                          state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          tile: Optional[int] = None):
    """Plain PyTorch version of the DC kernel on a real (B, n, n) batch:
    the same steps in the same order (unmasked ``T`` carry, one
    symmetrisation at the end of the sign iteration, ``G0 <- Q^T G0``
    accumulated, the 8 + 3 and 10 + 5 Newton-Schulz schedules, ``refine``
    re-projection passes).  Outputs ordered ``(g, [t], [seg])``; ``seg`` is
    (B, n, 1) int32.

    ``state = (t, seg)`` resumes the recursion: ``a`` is then the panel
    ``G0`` and ``(t, seg)`` the ``return_t`` and ``return_seg`` exports of
    an earlier call (of this function or of the kernel), and ``levels``
    more levels run from there.  Resuming after every level reproduces one
    call of all the levels; it is how a kernel's output is held against
    this version one level at a time, from the kernel's own state.

    ``tile``: None runs every product dense; a width runs each product only
    over the k-ranges that the kernel's output tiles of that width run
    (``dc_level.band_ranges`` of the ids the level starts from): the
    overlap of the row and column bands' ranges for the block-diagonal
    products (sign, probe, polar, refinement), the column band's for ``T Q``
    (``T`` is not masked) and the row band's for ``Q^T (T Q)`` and
    ``Q^T G0``.  Outside them every term is zero, so it gives the dense
    result."""
    _check_input(a, "dc_precondition_plain")
    B, n, _ = a.shape
    dt = a.dtype
    dev = a.device
    om = as_probe(om, n, dt, dev)
    qa, qb, qc = _QUINTIC
    eye = torch.eye(n, dtype=dt, device=dev)
    iot = torch.arange(n, device=dev)

    def msign(mm, X, mask):
        for _ in range(_N_QUINTIC_SIGN):
            X2 = mm(X, X)
            X4 = mm(X2, X2)
            X = mm(X, qa * eye + qb * X2 + qc * X4) * mask
        for _ in range(_N_CUBIC_SIGN):
            X2 = mm(X, X)
            X = (1.5 * X - 0.5 * mm(X, X2)) * mask
        return 0.5 * (X + X.mT)

    def polar_cubic(mm, Q, steps):
        for _ in range(steps):
            Gm = mm(Q, Q, ta=True)
            Q = 1.5 * Q - 0.5 * mm(Q, Gm)
        return Q

    def polar(mm, Q):
        for _ in range(_N_QUINTIC_POLAR):
            Gm = mm(Q, Q, ta=True)
            G2 = mm(Gm, Gm)
            Q = mm(Q, qa * eye + qb * Gm + qc * G2)
        return polar_cubic(mm, Q, _N_CUBIC_POLAR)

    def seg_max(v, seg_eq_b):
        # max of v over the positions of each position's segment (v >= 0)
        return torch.where(seg_eq_b, v[:, None, :], v.new_zeros(())).amax(-1)

    g = a.clone()
    if state is None:
        T = 0.5 * (a + a.mT)
        seg = torch.zeros((B, n), dtype=torch.int64, device=dev)
    else:
        T = state[0].to(dtype=dt, device=dev)
        seg = state[1].reshape(B, n).to(dtype=torch.int64, device=dev)
        if T.shape != a.shape:
            raise ValueError("dc_precondition_plain: state t must be %s, got %s"
                             % (tuple(a.shape), tuple(T.shape)))
    for _ in range(levels):
        bands = None if tile is None else (*dc_level.band_ranges(seg, tile), tile)
        mm = functools.partial(dc_level._product, bands=bands)
        seg_eq_b = seg[:, :, None] == seg[:, None, :]
        seg_eq = seg_eq_b.to(dt)
        sizes = seg_eq_b.sum(-1)
        starts = (seg[:, None, :] < seg[:, :, None]).sum(-1)
        froz = sizes <= min_seg
        fro_any_b = froz[:, :, None] | froz[:, None, :]
        fro_any = fro_any_b.to(dt)
        live = 1.0 - fro_any

        d = torch.diagonal(T, dim1=-2, dim2=-1)
        # rank of position j's diagonal inside its segment: members i with
        # (d_i, i) < (d_j, j), ties by index
        lt2 = (d[:, :, None] < d[:, None, :]) | (
            (d[:, :, None] == d[:, None, :]) & (iot[:, None] < iot[None, :]))
        rank = (seg_eq_b & lt2).sum(-2)                              # by j
        lo_t = torch.div(sizes - 1, 2, rounding_mode="floor")
        hi_t = torch.div(sizes, 2, rounding_mode="floor")
        is_lo = seg_eq * (rank[:, None, :] == lo_t[:, :, None])
        is_hi = seg_eq * (rank[:, None, :] == hi_t[:, :, None])
        sigma = 0.5 * ((is_lo * d[:, None, :]).sum(-1) + (is_hi * d[:, None, :]).sum(-1))

        C = T * seg_eq - sigma[:, :, None] * eye
        col1 = C.abs().sum(-2)
        bound = seg_max(col1, seg_eq_b)
        X = C / (1.01 * bound[:, :, None] + 1e-30)

        E = msign(mm, X, seg_eq * live)
        P = 0.5 * (eye * seg_eq - E) * live
        pd = torch.diagonal(P, dim1=-2, dim2=-1)
        tr = (seg_eq * pd[:, None, :]).sum(-1)
        # torch.round, like rintf and jnp.round, rounds half to even
        r = torch.minimum(torch.clamp(torch.round(tr).to(torch.int64), min=0), sizes)
        low = ((iot[None, :] - starts) < r) & ~froz

        omb = (fro_any * eye + (1.0 - fro_any) * om) * seg_eq
        POm = mm(P, omb)
        # rank-safety blend: see spectral_dc._dc_level at the Y construction
        Y = ((1.0 - _RANK_SAFE_BETA) * torch.where(low[:, None, :], POm, omb - POm)
             + _RANK_SAFE_BETA * omb)
        coln = torch.sqrt((Y * Y).sum(-2, keepdim=True))
        Y = Y / (coln + 1e-20)
        rmax = seg_max(Y.abs().sum(-1), seg_eq_b)
        cmax = seg_max(Y.abs().sum(-2), seg_eq_b)
        scale = 1.01 * torch.sqrt(rmax * cmax) + 1e-30
        Q = polar(mm, Y / scale[:, None, :])

        for _r in range(refine):
            # subspace refinement: re-project the orthonormal basis through
            # the projector (low slots through P, high slots through I - P)
            # and re-orthonormalise with a short cubic polar
            PQ = mm(P, Q)
            Q = torch.where(low[:, None, :], PQ, Q - PQ)
            # frozen segments keep their identity columns
            Q = torch.where(fro_any_b, eye * seg_eq, Q)
            coln = torch.sqrt((Q * Q).sum(-2, keepdim=True))
            Q = polar_cubic(mm, Q / (coln + 1e-20), _N_CUBIC_REFINE)

        # T is dense: T Q sums k over Q's column bands, Q^T (T Q) and
        # Q^T G0 over Q^T's row bands
        T = mm(Q, mm(T, Q, k_by="cols"), ta=True, k_by="rows")
        # the carry is not masked between levels: every use inside a level
        # applies the segment mask, so an exported T is exact at all
        # segment boundaries
        T = 0.5 * (T + T.mT)
        g = mm(Q, g, ta=True, k_by="rows")
        seg = seg * 2 + torch.where(low | froz, 0, 1)
    return _outputs(g, T, seg.to(torch.int32)[..., None], return_t, return_seg)


def dc_precondition_cuda(a: torch.Tensor, *, levels: int = 8, min_seg: int = 2,
                         return_t: bool = False, return_seg: bool = False,
                         refine: int = 0, om: Optional[torch.Tensor] = None):
    """Launch the DC kernel on a contiguous float32 CUDA batch (B, n, n)
    inside the window of :func:`fits_dc_kernel`: one call puts every level's
    kernels on the current stream and counts one launch.  Outputs ordered
    ``(g, [t], [seg])``; ``seg`` is (B, n, 1) int32."""
    _check_input(a, "dc_precondition_cuda")
    if not a.is_cuda or a.dtype != torch.float32 or not a.is_contiguous():
        raise RuntimeError("dc_precondition_cuda: expected a contiguous float32 "
                           "CUDA batch (B, n, n)")
    B, n, _ = a.shape
    if not fits_dc_kernel(B, n, levels, a.dtype) or min_seg < 0 or refine < 0:
        raise RuntimeError(
            "dc_precondition_cuda: a (%d, %d, %d) batch with levels=%d, min_seg=%d, "
            "refine=%d is outside the kernel's window (1 <= B, 1 <= n <= %d, "
            "0 <= levels <= %d, B <= %d, workspace B*%d*n*n*4 B <= %d B)"
            % (B, n, n, levels, min_seg, refine, _N_MAX, _LEVELS_MAX, _B_MAX,
               _WORK_PLANES, _WORK_BUDGET))
    om = as_probe(om, n, a.dtype, a.device)
    g = torch.empty_like(a)
    t = torch.empty_like(a) if return_t else None
    seg = torch.empty((B, n, 1), dtype=torch.int32, device=a.device) \
        if return_seg else None
    work = torch.empty((_WORK_PLANES, B, n, n), dtype=torch.float32, device=a.device)
    ivec = torch.empty((B, _IVEC, n), dtype=torch.int32, device=a.device)
    fvec = torch.empty((B, _FVEC, n), dtype=torch.float32, device=a.device)
    lib = _build.load("dc_kernel", _SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dc_precondition_f32(
            a.data_ptr(), om.data_ptr(), g.data_ptr(),
            t.data_ptr() if return_t else None,
            seg.data_ptr() if return_seg else None,
            work.data_ptr(), ivec.data_ptr(), fvec.data_ptr(), B, n, int(levels),
            int(min_seg), int(refine), stream)
    _build.check(rc, "dc_precondition_cuda")
    dc_precondition_cuda.launches += 1
    return _outputs(g, t, seg, return_t, return_seg)


dc_precondition_cuda.launches = 0


def _three(a, out, return_t: bool, return_seg: bool):
    """``(g, t, seg)`` from a call's outputs, an empty tensor in place of
    each one not asked for."""
    out = out if isinstance(out, tuple) else (out,)
    t = out[1] if return_t else a.new_empty(0)
    seg = out[-1] if return_seg else a.new_empty(0, dtype=torch.int32)
    return out[0], t, seg


@torch.library.custom_op("xitorch_tpu_torch::dc_precondition", mutates_args=(),
                         device_types="cpu")
def _dc_op(a: torch.Tensor, om: torch.Tensor, levels: int, min_seg: int, return_t: bool,
           return_seg: bool, refine: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The single-shot warm start as an operator, ``(g, t, seg)``: the kernel
    on CUDA tensors, the plain version on CPU tensors, so that
    ``torch.export`` can trace through a launch.  An output not asked for
    (``return_t``, ``return_seg``) is an empty tensor."""
    kw = dict(levels=levels, min_seg=min_seg, return_t=return_t, return_seg=return_seg,
              refine=refine, om=om)
    return _three(a, dc_precondition_plain(a, **kw), return_t, return_seg)


@_dc_op.register_kernel("cuda")
def _(a, om, levels, min_seg, return_t, return_seg, refine):
    kw = dict(levels=levels, min_seg=min_seg, return_t=return_t, return_seg=return_seg,
              refine=refine, om=om)
    return _three(a, dc_precondition_cuda(a, **kw), return_t, return_seg)


@_dc_op.register_fake
def _(a, om, levels, min_seg, return_t, return_seg, refine):
    B, n, _ = a.shape
    return (torch.empty_like(a), torch.empty_like(a) if return_t else a.new_empty(0),
            a.new_empty((B, n, 1) if return_seg else (0,), dtype=torch.int32))


def dc_precondition(a: torch.Tensor, *, levels: int = 8, min_seg: int = 2,
                    per_level: Optional[bool] = None, return_t: bool = False,
                    return_seg: bool = False, refine: int = 0,
                    om: Optional[torch.Tensor] = None):
    """``G0 = Q^T a`` warm-start panels for (B, n, n) symmetric ``a`` (the
    Jacobi caller passes the shifted, padded matrix): the kernel for a CUDA
    tensor (or an error), the plain version for a CPU tensor.  Counterpart
    of ``dc_precondition_tpu``.

    ``return_t`` also returns ``T = Q^T a Q`` of the last level (never
    masked, so exact at every segment boundary); ``return_seg`` the final
    (B, n, 1) int32 segment ids (non-decreasing along the index);
    ``refine`` runs that many re-projection passes per level.  Outputs are
    ordered ``(g, [t], [seg])``.  ``om``: the (n, n) probe, a tensor or a
    numpy array; ``None`` draws ``spectral_dc.default_probe`` (seed 1803,
    on the CPU, moved to ``a``'s device), so kernel and plain version see
    the same probe.

    ``per_level`` (``None``: n > 448, as in the reference) runs one level a
    launch (``ops/dc_level.py``), up to n = 768, and returns ``G0`` only:
    ``return_t``, ``return_seg`` and ``refine`` raise ``ValueError`` there,
    and so does a larger n (run the cold sweep for it).
    """
    n = a.shape[-1]
    if per_level is None:
        per_level = n > dc_level._PER_LEVEL_MIN_N
    if per_level:
        if return_t or return_seg or refine:
            raise ValueError(
                "dc_precondition: return_t, return_seg and refine are only supported "
                "by the single-shot path (per_level=False; the default for n <= %d); "
                "the per-level path returns G0 only" % dc_level._PER_LEVEL_MIN_N)
        if n > dc_level._PER_LEVEL_MAX_N:
            raise ValueError(
                "dc_precondition: the per-level path supports n <= %d, got n = %d "
                "(jacobi_eigh pads n to a multiple of 128 on this path first); run "
                "jacobi_eigh with precondition=False for larger matrices"
                % (dc_level._PER_LEVEL_MAX_N, n))
        return dc_level.dc_precondition_per_level(a, levels=levels, min_seg=min_seg,
                                                  om=om)
    check_device(a)
    om = as_probe(om, n, a.dtype, a.device)
    g, t, seg = _dc_op(a.contiguous(), om, int(levels), int(min_seg), bool(return_t),
                       bool(return_seg), int(refine))
    return _outputs(g, t, seg, return_t, return_seg)
