"""Batched CG for structured operators with its state on chip (counterpart
of xitorch_tpu/ops/structured_cg.py).

The headline solve workload (BASELINE config 3) is a hermitian operator
``A = diag(d) + tridiagonal coupling + V V^T`` applied matrix-free.  A
CG built from separate PyTorch operations streams ~10 (B, n) tensors
through device memory per iteration; the kernel in
``csrc/structured_cg.cu`` keeps the whole CG state (x, r, p, A p) and the
operator data (d, band planes, V) of one system in the shared memory of
one thread block and runs the whole solve there.

Structure supported: ``A x = d*x + sum_k (bl_k*x_{i-o_k} + bu_k*x_{i+o_k})
+ V (V^T x)`` with full-length band planes (``bl[..., k, :o_k] ==
bu[..., k, n-o_k:] == 0``).  On a CUDA float32 tensor
:func:`structured_cg_solve` launches the kernel (:func:`structured_cg_cuda`)
or raises; on a CPU tensor it runs :func:`structured_cg_plain`, the same
loop and stop rule in PyTorch.  The public entry is
``xitorch_tpu_torch.linalg.solve(A, B, method="structured_cg")``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from xitorch_tpu_torch.ops import _build
from xitorch_tpu_torch.ops.tridiag import use_kernel

__all__ = ["structured_cg_solve", "structured_cg_cuda", "structured_cg_plain",
           "fits_structured_cg"]

# Hopper (sm_90): a block may opt in to 227 KB of dynamic shared memory;
# the kernel also holds ~2.5 KB of static reduction scratch
_SMEM_OPTIN = 232448
_SMEM_STATIC = 4096
_MAX_RANK = 16   # kMaxRank in csrc/structured_cg.cu
_MAX_BANDS = 8   # kMaxBands

_P = ctypes.c_void_p
_SIGNATURES = {
    "structured_cg_f32": [_P] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_float] * 3 + [_P],
}


def fits_structured_cg(n: int, r: int, dtype, nb: int = 1) -> bool:
    """Whether one system's CG state and operator data fit one block's
    shared memory: (5 + 2*nb + r) planes of n floats (d, x, r, p, A p, the
    band planes and V)."""
    if dtype != torch.float32 or r > _MAX_RANK or nb > _MAX_BANDS:
        return False
    return (5 + 2 * nb + r) * n * 4 + _SMEM_STATIC <= _SMEM_OPTIN


def structured_cg_plain(d: torch.Tensor, bl: torch.Tensor, bu: torch.Tensor,
                        V: torch.Tensor, b: torch.Tensor,
                        offsets: Sequence[int], *, rtol: float, atol: float,
                        max_niter: int, eps: float = 1e-30
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on the flat layout: d, b (K, n),
    bl, bu (K, nb, n), V (K, r, n).  Same loop and same per-system stop
    rule: a converged row is frozen by a mask, so each row's iterate is
    the one the kernel returns.  Returns ``(x, iterations, sqrt(r.r))``."""

    def matvec(p):
        y = d * p
        for k, o in enumerate(offsets):
            y = y + bl[:, k] * F.pad(p[:, :-o], (o, 0))   # bl_i p_{i-o}
            y = y + bu[:, k] * F.pad(p[:, o:], (0, o))    # bu_i p_{i+o}
        vt = (V * p[:, None, :]).sum(-1, keepdim=True)    # (K, r, 1)
        return y + (V * vt).sum(1)

    bnorm2 = (b * b).sum(-1)
    stop2 = torch.clamp(rtol * rtol * bnorm2, min=atol * atol)
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rr = bnorm2
    it = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    # iterate to HALF the tolerance (0.25 on the squared norms), as the
    # reference kernel does
    active = rr / stop2 >= 0.25
    for _ in range(max_niter):
        if not bool(active.any()):
            break
        Ap = matvec(p)
        pAp = (p * Ap).sum(-1)
        alpha = (rr / torch.where(pAp == 0, eps, pAp))[:, None]
        rnew = r - alpha * Ap
        rr_new = (rnew * rnew).sum(-1)
        beta = (rr_new / torch.where(rr == 0, eps, rr))[:, None]
        a = active[:, None]
        x = torch.where(a, x + alpha * p, x)
        p = torch.where(a, rnew + beta * p, p)
        r = torch.where(a, rnew, r)
        rr = torch.where(active, rr_new, rr)
        it = it + active.to(torch.int32)
        active = active & (rr / stop2 >= 0.25)
    return x, it.to(torch.float32), torch.sqrt(rr)


def structured_cg_cuda(d: torch.Tensor, bl: torch.Tensor, bu: torch.Tensor,
                       V: torch.Tensor, b: torch.Tensor,
                       offsets: Sequence[int], *, rtol: float, atol: float,
                       max_niter: int, eps: float = 1e-30
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CG kernel on the flat layout of :func:`structured_cg_plain`
    (contiguous float32 CUDA tensors, K >= 1)."""
    K, n = b.shape
    nb, r = len(offsets), V.shape[1]
    shapes = ((d, (K, n)), (bl, (K, nb, n)), (bu, (K, nb, n)), (V, (K, r, n)),
              (b, (K, n)))
    for t, shape in shapes:
        if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != b.device:
            raise RuntimeError(
                "structured_cg_cuda: expected contiguous float32 CUDA tensors "
                "d, b (K, n), bl, bu (K, nb, n), V (K, r, n) on one device")
    if K == 0 or not fits_structured_cg(n, r, torch.float32, nb):
        raise RuntimeError("structured_cg_cuda: K=%d, n=%d, r=%d, nb=%d does not "
                           "fit the kernel" % (K, n, r, nb))
    if any(int(o) < 1 for o in offsets):
        raise RuntimeError("structured_cg_cuda: band offsets must be >= 1")
    offs = torch.tensor([int(o) for o in offsets], dtype=torch.int32,
                        device=b.device)
    x = torch.empty_like(b)
    it = torch.empty(K, dtype=torch.float32, device=b.device)
    res = torch.empty(K, dtype=torch.float32, device=b.device)
    lib = _build.load("structured_cg", _SIGNATURES)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.structured_cg_f32(
            d.data_ptr(), bl.data_ptr(), bu.data_ptr(), V.data_ptr(),
            b.data_ptr(), offs.data_ptr(), x.data_ptr(), it.data_ptr(),
            res.data_ptr(), K, n, nb, r, int(max_niter), rtol * rtol,
            atol * atol, eps, stream)
    _build.check(rc, "structured_cg_cuda")
    structured_cg_cuda.launches += 1
    return x, it, res


structured_cg_cuda.launches = 0


def structured_cg_solve(d: torch.Tensor, bl: torch.Tensor, bu: torch.Tensor,
                        V: torch.Tensor, b: torch.Tensor,
                        offsets: Tuple[int, ...] = (1,),
                        rtol: float = 1e-6, atol: float = 1e-8,
                        max_niter: Optional[int] = None,
                        eps: float = 1e-30
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw solve (no autograd) of ``A x = b`` for
    ``A = diag(d) + sum_k band_k + V V^T`` per batch element; the
    counterpart of ``structured_cg_pallas``.

    ``offsets`` is a tuple of band offsets (o >= 1); ``bl``/``bu`` hold the
    lower/upper band couplings as full-length planes, (*B, n) for the
    single-band case or (*B, nb, n).  d, b are (*B, n); V is (*B, n, r).
    Returns ``(x, iterations, resid)`` with iterations/resid of shape (*B,)
    (per system: each system stops on its own tolerance).
    """
    n = b.shape[-1]
    nb = len(offsets)
    if bl.dim() == d.dim() and nb == 1:  # single-band convenience layout
        bl = bl[..., None, :]
        bu = bu[..., None, :]
    if max_niter is None:
        max_niter = min(2 * n, 400)
    batch = torch.broadcast_shapes(d.shape[:-1], bl.shape[:-2], bu.shape[:-2],
                                   V.shape[:-2], b.shape[:-1])
    K = math.prod(batch)
    r = V.shape[-1]

    def flat2(a):
        return a.expand(*batch, n).reshape(K, n).contiguous()

    def flat3(a):
        return a.expand(*batch, nb, n).reshape(K, nb, n).contiguous()

    # V as (K, r, n): each of the r columns contiguous along n
    Vf = V.expand(*batch, n, r).reshape(K, n, r).transpose(1, 2).contiguous()
    impl = structured_cg_cuda if use_kernel(b) else structured_cg_plain
    x, it, res = impl(flat2(d), flat3(bl), flat3(bu), Vf, flat2(b),
                      tuple(offsets), rtol=rtol, atol=atol,
                      max_niter=max_niter, eps=eps)
    return x.reshape(*batch, n), it.reshape(batch), res.reshape(batch)
