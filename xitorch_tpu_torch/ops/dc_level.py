"""One level of the spectral divide-and-conquer warm start a launch, for
large n (counterpart of the per-level part of xitorch_tpu/ops/dc_kernel.py).

The single-shot warm start (``ops/dc_kernel.py``) runs the whole level
recursion of a matrix in one place.  For padded n above 448 the reference
runs one level a launch instead and carries the state ``(segment ids, T,
G0)`` through device memory between levels, with two changes to the
arithmetic that this module keeps:

* the matrix sign is a cubic-only Newton-Schulz schedule
  ``X <- 1.5 X - 0.5 X^3``: with no identity term the zeros across segments
  and in frozen rows survive without a mask a step, and there is no
  symmetrisation at its end;
* the rank-safety blend of the probe is the strong one, ``beta = 0.02``
  (the single-shot kernel's is 0.002): at n in (448, 768] the soft sign
  rounds projector ranks wrongly often enough that the hard slot split
  loses rank;

and ``T`` is masked to the level's blocks after ``T <- sym(Q^T T Q)``.

Of a level's 72 products the reference runs 61 at default precision (12 of
the 14 sign steps, the probe, the 10 quintic and 3 of the 5 cubic polar
steps) and 11 at HIGHEST (the last 2 sign and 2 polar steps, ``T Q``,
``Q^T (T Q)``, ``Q^T G0``).  The kernel runs all 72 in IEEE float32: with
any step group on TF32, its level parts from this module's, at the levels
where the sort amplifies rounding, by more than the level-by-level check
allows on some of 41 random batches (all 61 on TF32: 22 fail it; the probe
alone: 12; the first 3 cubic polar steps alone: 5; all IEEE: none;
``PERF.md`` §6, row 7).  And it runs each product only over the
k-ranges of the level's segments (:func:`band_ranges`), which gives the
dense result on every entry the level reads.

* :func:`dc_level_cuda` launches one level of the hand-written kernel
  sequence ``csrc/dc_level.cu`` on CUDA tensors and counts one launch;
* :func:`dc_level_plain` is the same level, step by step, in batched
  PyTorch, every product in IEEE arithmetic of the state's dtype (float32,
  or float64 for a reference run), dense or over the kernel's k-ranges
  (``tile``);
* :func:`dc_precondition_per_level` runs ``levels`` levels from
  ``T = sym(a)``, ``G0 = a``, ids 0, and returns ``G0``: the kernel for a
  CUDA tensor (or an error), the plain version for a CPU tensor.

Segment ids are (B, n, 1) int32, non-decreasing along the index.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from xitorch_tpu_torch.ops import _build
from xitorch_tpu_torch.ops.spectral_dc import _QUINTIC, as_probe
from xitorch_tpu_torch.ops.tridiag import check_device
from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["band_ranges", "dc_level_cuda", "dc_level_plain", "dc_precondition_per_level",
           "fits_dc_level"]

# above this padded n the warm start runs one level a launch (the
# reference's threshold: its single-shot kernel's working set stops fitting
# the TPU's scoped memory there, and the per-level arithmetic above is what
# it validated from there on)
_PER_LEVEL_MIN_N = 448
# the largest n the reference validated on this path; larger matrices run
# the cold sweep
_PER_LEVEL_MAX_N = 768
_RANK_SAFE_BETA_LEAN = 0.02
# the steps: 14 cubic sign, 10 quintic polar, 5 cubic polar
_N_CUBIC_SIGN = 14
_N_QUINTIC_POLAR = 10
_N_CUBIC_POLAR = 5
_PRODUCTS_PER_LEVEL = (2 * _N_CUBIC_SIGN + 1 + 3 * _N_QUINTIC_POLAR
                       + 2 * _N_CUBIC_POLAR + 3)
# rows of an output tile of the kernel's products: the width of a band
_TILE = 128

# window of the kernel: the bookkeeping vectors are kMaxN = 1024 long in
# shared memory; workspace four (n, n) float32 planes a matrix
_N_MAX = 1024
_WORK_PLANES = 4
_IVEC, _FVEC = 5, 5
_WORK_BUDGET = 8 << 30

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"dc_level_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]}


def fits_dc_level(B: int, n: int, dtype) -> bool:
    """Whether a (B, n, n) batch lies in the level kernel's window: float32,
    1 <= n <= 1024, workspace of at most 8 GiB."""
    return bool(dtype == torch.float32 and B >= 1 and 1 <= n <= _N_MAX
                and B * (_WORK_PLANES + 2) * n * n * 4 <= _WORK_BUDGET)


def _check_state(seg, T, G0, what: str):
    if T.dim() != 3 or T.shape[-1] != T.shape[-2] or T.is_complex() \
            or G0.shape != T.shape or G0.dtype != T.dtype:
        raise RuntimeError("%s expects real (B, n, n) T and G0 of one dtype, got %s %s "
                           "and %s %s" % (what, T.dtype, tuple(T.shape), G0.dtype,
                                          tuple(G0.shape)))
    B, n, _ = T.shape
    if seg.numel() != B * n:
        raise RuntimeError("%s: segment ids must be (B, n, 1) = (%d, %d, 1), got %s"
                           % (what, B, n, tuple(seg.shape)))


def _seg_max(v: torch.Tensor, seg_eq_b: torch.Tensor) -> torch.Tensor:
    """Max of ``v`` (>= 0) over the positions of each position's segment."""
    return torch.where(seg_eq_b, v[:, None, :], v.new_zeros(())).amax(-1)


def band_ranges(seg: torch.Tensor, tile: int = _TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k-ranges of the kernel's row bands: for each ``tile``-row band of
    each matrix, ``lo`` is the first index of the segment that holds the
    band's first row and ``hi`` one past the end of the segment that holds
    its last row.  ``seg``: (B, n, 1) ids, non-decreasing along the index
    (every segment a contiguous run).  Returns two (B, ceil(n / tile))
    int64 tensors."""
    B = seg.shape[0]
    seg = seg.reshape(B, -1).to(torch.int64)
    n = seg.shape[1]
    starts = (seg[:, None, :] < seg[:, :, None]).sum(-1)
    ends = starts + (seg[:, None, :] == seg[:, :, None]).sum(-1)
    first = torch.arange(0, n, tile, device=seg.device)
    last = torch.clamp(first + tile, max=n) - 1
    return starts[:, first], ends[:, last]


def _banded(a, b, lo, hi, tile: int, ta: bool, k_by: str) -> torch.Tensor:
    """``op(a) @ b`` as the kernels' tiles run it: output block (bi, bj)
    sums k over the overlap of the two bands' ranges when both operands are
    block-diagonal (``k_by="both"``), over the row band's when only op(A) is
    (``"rows"``), over the column band's when only B is (``"cols"``), and
    is zero where that range is empty."""
    B, n, _ = b.shape
    lo, hi = lo.tolist(), hi.tolist()
    out = b.new_zeros((B, n, n))
    for m in range(B):
        for bi in range(len(lo[m])):
            r = slice(bi * tile, min(n, (bi + 1) * tile))
            for bj in range(len(lo[m])):
                k0, k1 = (lo[m][bj], hi[m][bj]) if k_by == "cols" else (lo[m][bi], hi[m][bi])
                if k_by == "both":
                    k0, k1 = max(k0, lo[m][bj]), min(k1, hi[m][bj])
                if k0 >= k1:
                    continue
                c = slice(bj * tile, min(n, (bj + 1) * tile))
                ak = a[m, k0:k1, r].mT if ta else a[m, r, k0:k1]
                out[m, r, c] = dot_hi(ak, b[m, k0:k1, c])
    return out


def _product(a, b, *, ta: bool = False, k_by: str = "both",
             bands=None) -> torch.Tensor:
    """One product of a level, ``op(a) @ b`` (op = transpose when ``ta``) in
    IEEE arithmetic: dense, or with ``bands = (lo, hi, tile)`` only over the
    k-ranges the kernel's tiles run (``k_by``: see :func:`_banded`)."""
    if bands is None:
        return dot_hi(a.mT if ta else a, b)
    return _banded(a, b, *bands, ta, k_by)


def dc_level_plain(seg: torch.Tensor, T: torch.Tensor, G0: torch.Tensor,
                   om=None, min_seg: int = 2, tile=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of one level of the kernel, in its order of
    steps: ``(seg, T, G0)`` before the level to ``(seg, T, G0)`` after it.
    ``om``: the (n, n) probe (None draws ``spectral_dc.default_probe``).
    ``tile``: None runs every product dense; a width runs each product only
    over the k-ranges that the kernel's tiles of that width run
    (:func:`band_ranges`), which gives the dense result on every entry the
    level reads.  Every product runs in IEEE arithmetic of the state's
    dtype."""
    _check_state(seg, T, G0, "dc_level_plain")
    B, n, _ = T.shape
    bands = None if tile is None else (*band_ranges(seg, tile), tile)
    mm = functools.partial(_product, bands=bands)
    dt, dev = T.dtype, T.device
    om = as_probe(om, n, dt, dev)
    qa, qb, qc = _QUINTIC
    beta = _RANK_SAFE_BETA_LEAN
    eye = torch.eye(n, dtype=dt, device=dev)
    iot = torch.arange(n, device=dev)
    seg = seg.reshape(B, n).to(torch.int64)

    seg_eq_b = seg[:, :, None] == seg[:, None, :]
    seg_eq = seg_eq_b.to(dt)
    sizes = seg_eq_b.sum(-1)
    starts = (seg[:, None, :] < seg[:, :, None]).sum(-1)
    froz = sizes <= min_seg
    fro_any = (froz[:, :, None] | froz[:, None, :]).to(dt)
    live = 1.0 - fro_any

    d = torch.diagonal(T, dim1=-2, dim2=-1)
    # rank of position j's diagonal inside its segment: members i with
    # (d_i, i) < (d_j, j), ties by index
    lt2 = (d[:, :, None] < d[:, None, :]) | (
        (d[:, :, None] == d[:, None, :]) & (iot[:, None] < iot[None, :]))
    rank = (seg_eq_b & lt2).sum(-2)
    lo_t = torch.div(sizes - 1, 2, rounding_mode="floor")
    hi_t = torch.div(sizes, 2, rounding_mode="floor")
    is_lo = seg_eq * (rank[:, None, :] == lo_t[:, :, None])
    is_hi = seg_eq * (rank[:, None, :] == hi_t[:, :, None])
    sigma = 0.5 * ((is_lo * d[:, None, :]).sum(-1) + (is_hi * d[:, None, :]).sum(-1))

    C = T * seg_eq - sigma[:, :, None] * eye
    bound = _seg_max(C.abs().sum(-2), seg_eq_b)
    X = C * live / (1.01 * bound[:, :, None] + 1e-30)
    # cubic-only sign: no identity term, so the masked zeros stay zero
    for _ in range(_N_CUBIC_SIGN):
        X2 = mm(X, X)
        X = 1.5 * X - 0.5 * mm(X, X2)
    P = 0.5 * (eye - X) * live

    tr = (seg_eq * torch.diagonal(P, dim1=-2, dim2=-1)[:, None, :]).sum(-1)
    # torch.round, like rintf and jnp.round, rounds half to even
    r = torch.minimum(torch.clamp(torch.round(tr).to(torch.int64), min=0), sizes)
    low = ((iot[None, :] - starts) < r) & ~froz

    omb = (fro_any * eye + (1.0 - fro_any) * om) * seg_eq
    POm = mm(P, omb)
    Y = (1.0 - beta) * torch.where(low[:, None, :], POm, omb - POm) + beta * omb
    Y = Y / (torch.sqrt((Y * Y).sum(-2, keepdim=True)) + 1e-20)
    rmax = _seg_max(Y.abs().sum(-1), seg_eq_b)
    cmax = _seg_max(Y.abs().sum(-2), seg_eq_b)
    Q = Y / (1.01 * torch.sqrt(rmax * cmax) + 1e-30)[:, None, :]

    for _ in range(_N_QUINTIC_POLAR):
        Gm = mm(Q, Q, ta=True)
        Q = mm(Q, qa * eye + qb * Gm + qc * mm(Gm, Gm))
    for _ in range(_N_CUBIC_POLAR):
        Gm = mm(Q, Q, ta=True)
        Q = 1.5 * Q - 0.5 * mm(Q, Gm)

    # T is block-diagonal over the parent ids only: with bands, T Q is short
    # outside the level's blocks, which Q^T (T Q) on the blocks never reads
    Tn = mm(Q, mm(T, Q), ta=True)
    Tn = 0.5 * (Tn + Tn.mT) * seg_eq
    Gn = mm(Q, G0, ta=True, k_by="rows")
    seg = seg * 2 + torch.where(low | froz, 0, 1)
    return seg.to(torch.int32)[..., None], Tn, Gn


def _check_cuda(T: torch.Tensor, what: str, min_seg: int) -> None:
    if not T.is_cuda or T.dtype != torch.float32:
        raise RuntimeError("%s: expected float32 CUDA tensors" % what)
    B, n, _ = T.shape
    if not fits_dc_level(B, n, T.dtype) or min_seg < 0:
        raise RuntimeError(
            "%s: a (%d, %d, %d) batch with min_seg=%d is outside the kernel's window "
            "(1 <= B, 1 <= n <= %d, workspace B*%d*n*n*4 B <= %d B)"
            % (what, B, n, n, min_seg, _N_MAX, _WORK_PLANES + 2, _WORK_BUDGET))


def dc_level_cuda(seg: torch.Tensor, T: torch.Tensor, G0: torch.Tensor, om=None,
                  min_seg: int = 2) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch one level (``csrc/dc_level.cu``) on float32 CUDA tensors inside
    :func:`fits_dc_level`: ``(seg, T, G0)`` to new ``(seg, T, G0)``.
    ``dc_level_cuda.launches`` counts the levels launched, here and in
    :func:`dc_precondition_per_level`."""
    _check_state(seg, T, G0, "dc_level_cuda")
    _check_cuda(T, "dc_level_cuda", min_seg)
    B, n, _ = T.shape
    om = as_probe(om, n, T.dtype, T.device).contiguous()
    seg_in = seg.reshape(B, n, 1).to(torch.int32).contiguous()
    t_in, g_in = T.contiguous(), G0.to(T.device).contiguous()
    seg_out = torch.empty_like(seg_in)
    t_out, g_out = torch.empty_like(t_in), torch.empty_like(g_in)
    work = torch.empty((_WORK_PLANES, B, n, n), dtype=torch.float32, device=T.device)
    ivec = torch.empty((B, _IVEC, n), dtype=torch.int32, device=T.device)
    fvec = torch.empty((B, _FVEC, n), dtype=torch.float32, device=T.device)
    lib = _build.load("dc_level", _SIGNATURES)
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dc_level_f32(seg_in.data_ptr(), seg_out.data_ptr(), om.data_ptr(),
                              t_in.data_ptr(), t_out.data_ptr(), g_in.data_ptr(),
                              g_out.data_ptr(), work.data_ptr(), ivec.data_ptr(),
                              fvec.data_ptr(), B, n, int(min_seg), stream)
    _build.check(rc, "dc_level_cuda")
    dc_level_cuda.launches += 1
    return seg_out, t_out, g_out


dc_level_cuda.launches = 0


@torch.library.custom_op("xitorch_tpu_torch::dc_level", mutates_args=(),
                         device_types="cpu")
def _level_op(seg: torch.Tensor, T: torch.Tensor, G0: torch.Tensor, om: torch.Tensor,
              min_seg: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level as an operator, ``(seg, T, G0)`` to new ``(seg, T, G0)``:
    :func:`dc_level_cuda` on CUDA tensors, :func:`dc_level_plain` on CPU
    tensors, so that ``torch.export`` can trace through a launch."""
    return dc_level_plain(seg, T, G0, om=om, min_seg=min_seg)


@_level_op.register_kernel("cuda")
def _(seg, T, G0, om, min_seg):
    return dc_level_cuda(seg, T, G0, om=om, min_seg=min_seg)


@_level_op.register_fake
def _(seg, T, G0, om, min_seg):
    B, n, _ = T.shape
    return (T.new_empty((B, n, 1), dtype=torch.int32), torch.empty_like(T),
            torch.empty_like(G0))


def dc_precondition_per_level(a: torch.Tensor, *, levels: int, min_seg: int = 2,
                              om=None) -> torch.Tensor:
    """``G0 = Q^T a`` after ``levels`` levels from ``T = sym(a)``, ``G0 = a``,
    ids 0, one level a call of the level operator: the kernel for a CUDA
    tensor (one launch a level), the plain version for a CPU tensor."""
    if a.dim() != 3 or a.shape[-1] != a.shape[-2] or a.is_complex():
        raise RuntimeError("dc_precondition_per_level expects a real (B, n, n) batch, "
                           "got %s %s" % (a.dtype, tuple(a.shape)))
    check_device(a)
    B, n, _ = a.shape
    om = as_probe(om, n, a.dtype, a.device)
    T = (0.5 * (a + a.mT)).contiguous()
    seg = torch.zeros((B, n, 1), dtype=torch.int32, device=a.device)
    G = a.contiguous()
    for _ in range(levels):
        seg, T, G = _level_op(seg, T, G, om, int(min_seg))
    return G
