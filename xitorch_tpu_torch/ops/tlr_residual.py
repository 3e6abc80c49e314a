"""Fused residual verdict for solves with a tridiagonal-plus-low-rank
operator ``A = diag(d) + T(c) + V V^T`` (no counterpart in xitorch_tpu,
whose check is ``A.mm`` under XLA).

``linalg.solve``'s eager convergence check asks, over every column j of
every system k, whether ``||(A - e_j I) x - b|| > 10 max(rtol ||b||,
atol)``, and queues the verdict ``[failed, max resid, max stop]``.  On a
CUDA float32 tensor :func:`tlr_residual_cuda` computes that verdict in one
launch of ``csrc/tlr_residual.cu``, reading x, b, d, c and V once; on a
CPU tensor :func:`tlr_residual_plain` computes it with the same PyTorch
operations as the generic check.

Layout of the operator ``xitorch_tpu_torch::tlr_residual``: rows are
(system, column) pairs.  ``x``, ``b`` (K, J, n), each row contiguous;
``d`` (K, n); ``c`` (K, n - 1) (a scalar coupling expanded, stride 0) or
None; ``V`` (K, n, r), each system's block row-major, or None; ``e`` (K,
J) or None.  The system axis of d, c, V and e, and of b, may be a
broadcast (stride 0): nothing is copied.  :func:`tlr_residual_check` puts
``solve``'s tensors into it, or says that it cannot.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from xitorch_tpu_torch.ops import _build
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["tlr_residual_check", "tlr_residual_cuda", "tlr_residual_plain", "fits_tlr_residual",
           "residual_verdict"]

# kE * kMaxThreads and the largest rank of csrc/tlr_residual.cu
_MAX_N = 4096
_MAX_RANK = 8

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "tlr_residual_f32": [_P] * 9 + [_LL, _LL] + [ctypes.c_int] * 3 + [_LL] * 9
    + [ctypes.c_float, ctypes.c_float, _P],
    "tlr_residual_slots": [],
}
# the launches' scratch, one a (device, stream): the ticket word (the
# kernel's last block sets it back to 0) and the blocks' partial verdicts,
# 3 floats for each of the most blocks the library launches on the device
_SCRATCH: dict = {}


def fits_tlr_residual(n: int, r: int) -> bool:
    """Whether the kernel takes systems of size n with a low-rank factor of
    rank r (0: no V)."""
    return 1 <= n <= _MAX_N and 0 <= r <= _MAX_RANK


def residual_verdict(resid: torch.Tensor, stop: torch.Tensor) -> torch.Tensor:
    """The check's verdict ``[failed, max resid, max stop]`` from each
    column's residual norm and stop: failed where any ``resid > 10 stop``."""
    return torch.stack([(resid > 10 * stop).any().to(resid.dtype), resid.max(), stop.max()])


def tlr_residual_plain(x: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
                       c: Optional[torch.Tensor], V: Optional[torch.Tensor],
                       e: Optional[torch.Tensor], rtol: float, atol: float) -> torch.Tensor:
    """The verdict ``[failed, max resid, max stop]`` in plain PyTorch, by the
    generic check's operations (the operator's matvec, then the norms)."""
    y = d[:, None, :] * x
    if c is not None:
        cc = c[:, None, :]
        y = y + F.pad(cc * x[..., 1:], (0, 1))
        y = y + F.pad(cc * x[..., :-1], (1, 0))
    if V is not None:
        vtx = einsum_hi("knq,kjn->kjq", V, x)
        y = y + einsum_hi("knq,kjq->kjn", V, vtx)
    if e is not None:
        y = y - x * e[..., None]
    resid = torch.linalg.norm(y - b, dim=-1)
    bnorm = torch.linalg.norm(b, dim=-1)
    stop = torch.clamp(rtol * bnorm, min=atol)
    return residual_verdict(resid, stop)


def _stride(t: Optional[torch.Tensor], dim: int) -> int:
    # a dimension of size 1 is read at index 0 only: its stride is moot
    if t is None or t.shape[dim] == 1:
        return 0
    return t.stride(dim)


def _rows_ok(x, b, d, c, V) -> bool:
    # the kernel reads each row of x, b and d, and each system's (n, r)
    # block of V, as contiguous memory; a coupling plane with stride 1 or 0
    # (a value a system)
    return (x[0, 0].is_contiguous() and b[0, 0].is_contiguous() and d[0].is_contiguous()
            and (V is None or V[0].is_contiguous())
            and (c is None or _stride(c, -1) in (0, 1)))


def _scratch(lib, device: torch.device):
    # (ticket word, partial verdicts) of the current stream on device
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _SCRATCH:
        slots = lib.tlr_residual_slots()
        if slots < 1:
            raise RuntimeError("tlr_residual_cuda: the device's SM count could not be read")
        _SCRATCH[key] = (torch.zeros(1, dtype=torch.int32, device=device),
                         torch.empty(3 * slots, dtype=torch.float32, device=device))
    return _SCRATCH[key]


def tlr_residual_cuda(x: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
                      c: Optional[torch.Tensor], V: Optional[torch.Tensor],
                      e: Optional[torch.Tensor], rtol: float, atol: float) -> torch.Tensor:
    """Launch the residual kernel on CUDA float32 tensors in the operator's
    layout (module docstring); returns the (3,) verdict on the card,
    without a synchronise."""
    K, J, n = x.shape
    r = 0 if V is None else V.shape[-1]
    shapes = {"b": (b, (K, J, n)), "d": (d, (K, n)), "c": (c, (K, n - 1)),
              "V": (V, (K, n, r)), "e": (e, (K, J))}
    for name, (t, shape) in shapes.items():
        if t is not None and tuple(t.shape) != shape:
            raise RuntimeError("tlr_residual_cuda: %s must be %s (got %s)"
                               % (name, shape, tuple(t.shape)))
    present = [t for t in (x, b, d, c, V, e) if t is not None]
    if any(not t.is_cuda or t.dtype != torch.float32 or t.device != x.device
           for t in present):
        raise RuntimeError("tlr_residual_cuda: float32 CUDA tensors on one device only")
    if K * J == 0 or not fits_tlr_residual(n, r) or not _rows_ok(x, b, d, c, V):
        raise RuntimeError(
            "tlr_residual_cuda: K=%d, J=%d, n=%d, rank %d, or a row that is not "
            "contiguous, is outside the kernel (n <= %d, rank <= %d)"
            % (K, J, n, r, _MAX_N, _MAX_RANK))
    # a coupling read once a system (a scalar expanded) or as a plane of n - 1
    c_mode = 0 if c is None or n == 1 else (1 if _stride(c, -1) == 0 else 2)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    lib = _build.load("tlr_residual", _SIGNATURES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        counter, partial = _scratch(lib, x.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tlr_residual_f32(
            ptr(x), ptr(b), ptr(d), ptr(c), ptr(V), ptr(e), partial.data_ptr(),
            counter.data_ptr(), out.data_ptr(), K, J, n, r, c_mode,
            _stride(x, 0), _stride(x, 1), _stride(b, 0), _stride(b, 1), _stride(d, 0),
            _stride(c, 0), _stride(V, 0), _stride(e, 0), _stride(e, 1),
            rtol, atol, stream)
    _build.check(rc, "tlr_residual_cuda")
    tlr_residual_cuda.launches += 1
    return out


tlr_residual_cuda.launches = 0


@torch.library.custom_op("xitorch_tpu_torch::tlr_residual", mutates_args=(),
                         device_types="cpu")
def _tlr_residual_op(x: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
                     c: Optional[torch.Tensor], V: Optional[torch.Tensor],
                     e: Optional[torch.Tensor], rtol: float, atol: float) -> torch.Tensor:
    """The verdict as an operator: :func:`tlr_residual_cuda` on CUDA tensors,
    :func:`tlr_residual_plain` on CPU tensors."""
    return tlr_residual_plain(x, b, d, c, V, e, rtol, atol)


@_tlr_residual_op.register_kernel("cuda")
def _(x, b, d, c, V, e, rtol, atol):
    return tlr_residual_cuda(x, b, d, c, V, e, rtol, atol)


@_tlr_residual_op.register_fake
def _(x, b, d, c, V, e, rtol, atol):
    return x.new_empty(3)


def _flat(t: torch.Tensor, shape, flat) -> Optional[torch.Tensor]:
    # t broadcast to shape, then viewed as flat; None where no view (a copy)
    # gives it
    try:
        return t.expand(shape).view(flat)
    except RuntimeError:
        return None


def tlr_residual_check(d: torch.Tensor, c: torch.Tensor, V: Optional[torch.Tensor],
                       x: torch.Tensor, B: torch.Tensor, E: Optional[torch.Tensor],
                       rtol: float, atol: float) -> Optional[torch.Tensor]:
    """The eager check's verdict for ``solve``'s tensors: ``d``, ``c`` and
    ``V`` of a :class:`TridiagLowRankOperator`, the solution ``x`` and
    right-hand side ``B`` (*batch, n, ncols), the shifts ``E`` (*BE, ncols)
    or None.  None where the kernel's layout does not take them without a
    copy: n or the rank outside :func:`fits_tlr_residual`, a column of x or
    B, d, a coupling plane or a row of V not contiguous along n, a
    broadcast that no stride expresses, or nothing to check."""
    n, J = x.shape[-2:]
    batch = tuple(x.shape[:-2])
    K = math.prod(batch)
    r = 0 if V is None else V.shape[-1]
    if K * J == 0 or not fits_tlr_residual(n, r):
        return None
    xr = _flat(x.transpose(-1, -2), (*batch, J, n), (K, J, n))
    br = _flat(B.transpose(-1, -2), (*batch, J, n), (K, J, n))
    dr = _flat(d, (*batch, n), (K, n))
    cr = None
    if n > 1 and c.ndim == 0:
        cr = c.expand(K, n - 1)
    elif n > 1 and c.shape[-1] == n - 1:
        cr = _flat(c, (*batch, n - 1), (K, n - 1))
        if cr is None:
            return None
    Vr = None if V is None else _flat(V, (*batch, n, r), (K, n, r))
    er = None if E is None else _flat(E, (*batch, J), (K, J))
    if any(t is None for t in (xr, br, dr)) or (V is not None and Vr is None) \
            or (E is not None and er is None) or not _rows_ok(xr, br, dr, cr, Vr):
        return None
    return _tlr_residual_op(xr, br, dr, cr, Vr, er, float(rtol), float(atol))
