"""Fused conjugate-gradient solve for explicit batched A (counterpart of
xitorch_tpu/ops/fused_cg.py).

The matrix-free ``cg`` of ``_impls/linalg/solve.py`` is a Python loop: a
dozen small launches and one host synchronisation per step, so the card
idles most of the time.  The kernel in ``csrc/fused_cg.cu`` runs the whole
iteration (unpreconditioned CG from x0 = 0) in one launch: a thread block
owns one system and a group of G of its right-hand sides, keeps their x, r,
p and A p in shared memory, and reads A from L2 / device memory on every
step.

The reference kernel rests on A living in on-chip memory; here 700^2 float32
is 1.96 MB against 227 KB of shared memory a block, so that does not carry.
What carries is the point: no host round trip inside the iteration.

**Window** (:func:`fits_fused_cg`), from the kernel's own shared-memory
layout: the state of a group is ``4 * G * n`` elements and the smallest
group is one column, so a shape fits when ``4 * n * itemsize + 4096`` (the
static reduction scratch, rounded up) is at most the 232,448 bytes a Hopper
block may opt in to: n <= 14,272 in float32, n <= 7,136 in float64 (the
card has float64 units, so both are instantiated).  Complex stays outside.
:func:`group_size` picks G: the largest of 8, 4, 2, 1 whose state fits, then
halved while the launch would have fewer blocks than the card has SMs (132)
or half the group would already hold every column.

**Stop rule.**  The reference stops a system when the maximum over ALL its
columns of ``sqrt(r.r) / max(rtol |b|, atol)`` drops below 1; the kernel
applies the same rule to each group of columns, since nothing crosses
blocks.  That changes only how far already-converged columns are polished.
:func:`fused_cg_plain` has both rules (``group=None`` is the reference's).

On a CUDA tensor :func:`fused_cg_dense` launches the kernel
(:func:`fused_cg_cuda`) or raises; on a CPU tensor it runs
:func:`fused_cg_plain` with the reference's joint rule.  The public entry is
``xitorch_tpu_torch.linalg.solve(A, B, method="fused_cg")``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from xitorch_tpu_torch.ops import _build
from xitorch_tpu_torch.ops.tridiag import use_kernel
from xitorch_tpu_torch.utils.tensor import dot_hi

__all__ = ["fused_cg_dense", "fused_cg_cuda", "fused_cg_plain", "fits_fused_cg",
           "group_size"]

# Hopper (sm_90): a block may opt in to 227 KB of dynamic shared memory; the
# kernel also holds up to 1 KB of static reduction scratch
_SMEM_OPTIN = 232448
_SMEM_STATIC = 4096
_SM_COUNT = 132   # H100 SXM
_MAX_GROUP = 8    # the largest instantiation in csrc/fused_cg.cu

_P = ctypes.c_void_p
_ARGS = [_P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_double] * 3 + [_P]
_SIGNATURES = {"fused_cg_f32": _ARGS, "fused_cg_f64": _ARGS}


def _state_fits(n: int, group: int, itemsize: int) -> bool:
    return 4 * group * n * itemsize + _SMEM_STATIC <= _SMEM_OPTIN


def fits_fused_cg(n: int, ncols: int, dtype) -> bool:
    """Whether the kernel takes an (n, n) system with ``ncols`` right-hand
    sides: float32 or float64, and one column's CG state (x, r, p, A p)
    fits one block's shared memory."""
    if dtype not in (torch.float32, torch.float64):
        return False
    itemsize = 4 if dtype == torch.float32 else 8
    return n >= 1 and ncols >= 1 and _state_fits(n, 1, itemsize)


def group_size(nb: int, n: int, ncols: int, dtype) -> int:
    """Columns a block owns for ``nb`` systems of size n with ``ncols``
    right-hand sides (see the module docstring)."""
    itemsize = 4 if dtype == torch.float32 else 8
    g = _MAX_GROUP
    while g > 1 and (not _state_fits(n, g, itemsize) or g // 2 >= ncols
                     or nb * -(-ncols // g) < _SM_COUNT):
        g //= 2
    return g


def fused_cg_plain(A: torch.Tensor, B: torch.Tensor, *, rtol: float, atol: float,
                   max_niter: int, eps: float = 1e-12,
                   group: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: A (nb, n, n), B (nb, n, nc).
    The same loop, zero-denominator rule and stop rule: each group of
    ``group`` consecutive columns of a system runs while any of its columns
    has ``sqrt(r.r) / max(rtol |b|, atol) >= 1``; a group that has stopped
    is frozen by a mask, so its iterate is the one the kernel returns.
    ``group=None`` is one group of all the columns, the reference's rule.
    Returns ``(x, steps)`` with steps (nb, ngroups) int32."""
    nb, n, nc = B.shape
    group = nc if group is None else int(group)
    ngroups = -(-nc // group)

    def colsum(a):
        return a.sum(-2, keepdim=True)  # (nb, 1, nc)

    def group_any(flag):
        # (nb, 1, nc) bool: true for every column of a group that holds one
        pad = torch.zeros((nb, ngroups * group - nc), dtype=torch.bool, device=B.device)
        per_group = torch.cat([flag[:, 0], pad], -1).reshape(nb, ngroups, group).any(-1)
        return per_group, per_group.repeat_interleave(group, -1)[:, None, :nc]

    stop = torch.clamp(rtol * torch.sqrt(colsum(B * B)), min=atol)
    x = torch.zeros_like(B)
    r = B.clone()
    p = B.clone()
    rr = colsum(r * r)
    it = torch.zeros((nb, ngroups), dtype=torch.int32, device=B.device)
    for _ in range(max_niter):
        per_group, active = group_any(torch.sqrt(rr) / stop >= 1.0)
        if not bool(per_group.any()):
            break
        Ap = dot_hi(A, p)
        pAp = colsum(p * Ap)
        alpha = rr / torch.where(pAp == 0, eps, pAp)
        r_new = r - alpha * Ap
        rr_new = colsum(r_new * r_new)
        beta = rr_new / torch.where(rr == 0, eps, rr)
        x = torch.where(active, x + alpha * p, x)
        p = torch.where(active, r_new + beta * p, p)
        r = torch.where(active, r_new, r)
        rr = torch.where(active, rr_new, rr)
        it = it + per_group.to(torch.int32)
    return x, it


def fused_cg_cuda(A: torch.Tensor, a_idx: torch.Tensor, B: torch.Tensor, *,
                  rtol: float, atol: float, max_niter: int, eps: float = 1e-12,
                  group: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: A (nA, n, n) and B (nb, n, nc) contiguous CUDA
    tensors of one dtype (float32 or float64), ``a_idx`` (nb,) int64 the
    index into A of each system's matrix.  ``group`` defaults to
    :func:`group_size`.  Returns ``(x, steps)`` with steps (nb, ngroups)
    int32, the steps each block took."""
    if B.dim() != 3 or A.dim() != 3:
        raise RuntimeError("fused_cg_cuda: A must be (nA, n, n) and B (nb, n, nc)")
    nb, n, nc = B.shape
    nA = A.shape[0]
    for t, shape, dtype in ((A, (nA, n, n), B.dtype), (B, (nb, n, nc), B.dtype),
                            (a_idx, (nb,), torch.int64)):
        if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != B.device:
            raise RuntimeError(
                "fused_cg_cuda: expected contiguous CUDA tensors A (nA, n, n) and "
                "B (nb, n, nc) of one dtype and a_idx (nb,) int64, on one device")
    if nb == 0 or nA == 0 or not fits_fused_cg(n, nc, B.dtype):
        raise RuntimeError("fused_cg_cuda: nb=%d, n=%d, ncols=%d, %s does not fit the "
                           "kernel" % (nb, n, nc, B.dtype))
    if group is None:
        group = group_size(nb, n, nc, B.dtype)
    if group not in (1, 2, 4, 8) or not _state_fits(n, group, B.element_size()):
        raise RuntimeError("fused_cg_cuda: a group of %d columns at n=%d does not fit "
                           "a block's shared memory" % (group, n))
    ngroups = -(-nc // group)
    x = torch.empty_like(B)
    it = torch.empty((nb, ngroups), dtype=torch.int32, device=B.device)
    lib = _build.load("fused_cg", _SIGNATURES)
    fn = lib.fused_cg_f32 if B.dtype == torch.float32 else lib.fused_cg_f64
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(A.data_ptr(), a_idx.data_ptr(), B.data_ptr(), x.data_ptr(),
                it.data_ptr(), nb, n, nc, group, int(max_niter), float(rtol),
                float(atol), float(eps), stream)
    _build.check(rc, "fused_cg_cuda")
    fused_cg_cuda.launches += 1
    return x, it


fused_cg_cuda.launches = 0


def fused_cg_dense(Amat: torch.Tensor, B: torch.Tensor, rtol: float = 1e-6,
                   atol: float = 1e-8, max_niter: Optional[int] = None,
                   eps: float = 1e-12, return_steps: bool = False):
    """Solve ``A X = B`` for hermitian positive definite dense A
    ``(*BA, n, n)`` and B ``(*BB, n, nc)`` by unpreconditioned CG from
    x0 = 0 (no autograd); the counterpart of the reference's
    ``fused_cg_dense``.  ``max_niter`` defaults to ``int(1.5 * n)``.  The
    batch dims broadcast; a broadcast A is indexed, not copied.  With
    ``return_steps`` also the step counts ``(*batch, ngroups)``."""
    n, nc = B.shape[-2:]
    if Amat.shape[-2:] != (n, n) or Amat.dtype != B.dtype:
        raise RuntimeError("fused_cg_dense: A %s (%s) does not match B %s (%s)"
                           % (tuple(Amat.shape), Amat.dtype, tuple(B.shape), B.dtype))
    if not fits_fused_cg(n, nc, B.dtype):
        raise RuntimeError("fused_cg_dense: n=%d, ncols=%d, %s is outside the kernel's "
                           "window (fits_fused_cg)" % (n, nc, B.dtype))
    if max_niter is None:
        max_niter = int(1.5 * n)
    batch = torch.broadcast_shapes(Amat.shape[:-2], B.shape[:-2])
    nb = math.prod(batch)
    B3 = B.expand(*batch, n, nc).reshape(nb, n, nc).contiguous()
    nA = math.prod(Amat.shape[:-2])
    A3 = Amat.reshape(nA, n, n).contiguous()
    # which matrix each system takes: A's batch dims broadcast against B's
    a_idx = torch.arange(nA, device=B.device).reshape(Amat.shape[:-2]) \
        .expand(batch).reshape(nb).contiguous()
    kw = dict(rtol=rtol, atol=atol, max_niter=max_niter, eps=eps)
    if use_kernel(B):
        x, it = fused_cg_cuda(A3, a_idx, B3, **kw)
    else:
        x, it = fused_cg_plain(A3[a_idx], B3, **kw)
    x = x.reshape(*batch, n, nc)
    return (x, it.reshape(*batch, -1)) if return_steps else x
