"""Batched CG for structured operators with its state on chip (counterpart
of xitorch_tpu/ops/structured_cg.py).

The headline solve workload (BASELINE config 3) is a hermitian operator
``A = diag(d) + tridiagonal coupling + V V^T`` applied matrix-free.  A
CG built from separate PyTorch operations streams ~10 (B, n) tensors
through device memory per iteration; the kernels in
``csrc/structured_cg.cu`` keep the whole CG state (x, r, p) and the
operator data (d, band planes, V) of one system on chip in one thread
block and run the whole solve there.

**Designs** (:func:`choose_path`, recorded in
``structured_cg_cuda.last_design``).  "register": each thread holds 8
consecutive elements of every plane in registers, two block barriers a
step; it takes up to 2 bands of offset <= 8 and rank <= 8, for n up to
:func:`register_window`.  "shared": every plane in the block's shared
memory, four barriers a step; the path for the other shapes whose planes
fit (up to 8 bands, rank <= 16).  ``path=`` forces one, for measuring; a
shape the forced path does not take, or a launch failure, raises.

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
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from xitorch_tpu_torch.debug.profiling import count
from xitorch_tpu_torch.ops import _build
from xitorch_tpu_torch.ops.tridiag import check_device

__all__ = ["structured_cg_solve", "structured_cg_cuda", "structured_cg_plain",
           "fits_structured_cg", "choose_path", "register_window", "register_attrs"]

# Hopper (sm_90): a block may opt in to 227 KB of dynamic shared memory;
# the kernel also holds ~2.5 KB of static reduction scratch
_SMEM_OPTIN = 232448
_SMEM_STATIC = 4096
_MAX_RANK = 16   # kMaxRank in csrc/structured_cg.cu
_MAX_BANDS = 8   # kMaxBands

# the register design: elements a thread (kE), and the bands, band offset
# and rank it takes
_REG_E = 8
_REG_MAX_BANDS, _REG_MAX_OFFSET, _REG_MAX_RANK = 2, 8, 8
# register_window's values by (device index, rank, bands)
_WINDOWS: dict = {}

_P = ctypes.c_void_p
_SIGNATURES = {
    "structured_cg_f32": [_P] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_float] * 3 + [_P],
    "structured_cg_reg_f32": [_P] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_float] * 3 + [_P],
    "structured_cg_reg_attrs": [ctypes.c_int, ctypes.c_int, _P, _P],
}


def register_window(r: int, nb: int, device: torch.device) -> int:
    """Largest n the register design takes at rank r with nb bands on this
    CUDA device (0: that rank or band count is outside it): 8 elements a
    thread times the most threads a block of the compiled instantiation can
    launch with (:func:`register_attrs`), read once a device."""
    if not (1 <= r <= _REG_MAX_RANK and 1 <= nb <= _REG_MAX_BANDS):
        return 0
    key = (device.index, r, nb)
    if key not in _WINDOWS:
        _WINDOWS[key] = _REG_E * register_attrs(r, nb, device)[1]
    return _WINDOWS[key]


def _fits_shared(n: int, r: int, nb: int) -> bool:
    """Whether one system's CG state and operator data fit one block's
    shared memory: (5 + 2*nb + r) planes of n floats (d, x, r, p, A p, the
    band planes and V)."""
    return r <= _MAX_RANK and nb <= _MAX_BANDS \
        and (5 + 2 * nb + r) * n * 4 + _SMEM_STATIC <= _SMEM_OPTIN


def choose_path(n: int, r: int, offsets: Sequence[int], window: int) -> Optional[str]:
    """The kernel design for a system of n unknowns, rank r and these band
    offsets, given the register design's ``window`` (:func:`register_window`
    at r and the band count): "register" inside it, for up to 2 bands of
    offset <= 8, else "shared" where the planes fit a block's shared
    memory, else None (no kernel takes it)."""
    nb = len(offsets)
    if 1 <= nb <= _REG_MAX_BANDS and max(offsets) <= _REG_MAX_OFFSET and n <= window:
        return "register"
    if _fits_shared(n, r, nb):
        return "shared"
    return None


def fits_structured_cg(n: int, r: int, dtype, nb: int = 1) -> bool:
    """Whether a kernel design takes the shape (float32 only): whether its
    planes fit the shared-memory design, whose window holds the register
    design's (a card test holds that to the build)."""
    return dtype == torch.float32 and _fits_shared(n, r, nb)


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
                       max_niter: int, eps: float = 1e-30, path: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CG kernel on the flat layout of :func:`structured_cg_plain`
    (contiguous float32 CUDA tensors, K >= 1).  The design comes from
    :func:`choose_path` and is recorded in ``structured_cg_cuda.last_design``;
    ``path`` ("register" or "shared") forces one, for measuring."""
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
    if any(int(o) < 1 for o in offsets):
        raise RuntimeError("structured_cg_cuda: band offsets must be >= 1")
    chosen = choose_path(n, r, tuple(int(o) for o in offsets),
                         register_window(r, nb, b.device))
    if path is None:
        path = chosen
    elif path not in ("register", "shared"):
        raise RuntimeError("structured_cg_cuda: path must be 'register' or 'shared'")
    elif path == "shared" and not _fits_shared(n, r, nb) \
            or path == "register" and chosen != "register":
        path = None
    if K == 0 or path is None:
        raise RuntimeError("structured_cg_cuda: K=%d, n=%d, r=%d, offsets %s does not "
                           "fit the kernel's %s design" % (K, n, r, tuple(offsets),
                                                          path or "chosen"))
    # host memory: the kernel takes the offsets by value (a copy to the
    # device would synchronise the stream)
    offs = (ctypes.c_int * nb)(*(int(o) for o in offsets))
    x = torch.empty_like(b)
    it = torch.empty(K, dtype=torch.float32, device=b.device)
    res = torch.empty(K, dtype=torch.float32, device=b.device)
    lib = _build.load("structured_cg", _SIGNATURES)
    fn = lib.structured_cg_reg_f32 if path == "register" else lib.structured_cg_f32
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(d.data_ptr(), bl.data_ptr(), bu.data_ptr(), V.data_ptr(),
                b.data_ptr(), ctypes.addressof(offs), x.data_ptr(), it.data_ptr(),
                res.data_ptr(), K, n, nb, r, int(max_niter), rtol * rtol,
                atol * atol, eps, stream)
    _build.check(rc, "structured_cg_cuda")
    structured_cg_cuda.launches += 1
    structured_cg_cuda.last_design = path
    return x, it, res


def register_attrs(r: int, nb: int, device: torch.device) -> Tuple[int, int]:
    """The compiled register design's registers a thread and the most
    threads a block of it can launch with, on this CUDA device
    (``cudaFuncGetAttributes``)."""
    lib = _build.load("structured_cg", _SIGNATURES)
    regs, threads = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = lib.structured_cg_reg_attrs(r, nb, ctypes.addressof(regs),
                                         ctypes.addressof(threads))
    _build.check(rc, "structured_cg_reg_attrs")
    return regs.value, threads.value


structured_cg_cuda.launches = 0
structured_cg_cuda.last_design = None


@torch.library.custom_op("xitorch_tpu_torch::structured_cg", mutates_args=(),
                         device_types="cpu")
def _structured_cg_op(d: torch.Tensor, bl: torch.Tensor, bu: torch.Tensor, V: torch.Tensor,
                      b: torch.Tensor, offsets: List[int], rtol: float, atol: float,
                      max_niter: int, eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CG solve as an operator on the flat layout: :func:`structured_cg_cuda`
    on CUDA tensors, :func:`structured_cg_plain` on CPU tensors, so that
    ``torch.export`` can trace through a launch."""
    return structured_cg_plain(d, bl, bu, V, b, tuple(offsets), rtol=rtol, atol=atol,
                               max_niter=max_niter, eps=eps)


@_structured_cg_op.register_kernel("cuda")
def _(d, bl, bu, V, b, offsets, rtol, atol, max_niter, eps):
    return structured_cg_cuda(d, bl, bu, V, b, tuple(offsets), rtol=rtol, atol=atol,
                              max_niter=max_niter, eps=eps)


@_structured_cg_op.register_fake
def _(d, bl, bu, V, b, offsets, rtol, atol, max_niter, eps):
    K = b.shape[0]
    return (torch.empty_like(b), b.new_empty(K, dtype=torch.float32), b.new_empty(K))


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
    check_device(b)
    x, it, res = _structured_cg_op(flat2(d), flat3(bl), flat3(bu), Vf, flat2(b),
                                   [int(o) for o in offsets], float(rtol), float(atol),
                                   int(max_niter), float(eps))
    count("structured_cg", it)
    return x.reshape(*batch, n), it.reshape(batch), res.reshape(batch)
