"""First-order gradients of a solve's operator parameters for a
tridiagonal-plus-low-rank operator ``A = diag(d) + T(c) + V V^T`` (no
counterpart in xitorch_tpu, which leaves them to ``jax.vjp`` of the
matvec under XLA).

``linalg.solve``'s backward needs the gradient of ``-lam^T (A - E) x`` to
d, c, V and E with the solution x held fixed, lam being the adjoint
solution.  In closed form, over the columns j of each system k:

* ``gd = -sum_j lam * x``
* ``gV = -sum_j (lam (V^T x)^T + x (V^T lam)^T)``
* ``gc = -sum (lam_i x_{i+1} + lam_{i+1} x_i)`` per bond and system for a
  (K, n - 1) coupling, over everything for a scalar one
* ``gE[k, j] = sum_i lam * x``

On CUDA float32 tensors :func:`tlr_grad_cuda` computes them in one launch
of ``csrc/tlr_grad.cu``, reading lam, x and V once; on CPU tensors
:func:`tlr_grad_plain` computes the same closed form in PyTorch.

Layout of the operator ``xitorch_tpu_torch::tlr_grad``: rows are (system,
column) pairs.  ``lam``, ``x`` (K, J, n), each row contiguous; ``V`` (K, n,
r), each system's block row-major, or None where gV is not asked for;
``want_d``, ``want_e`` whether gd and gE are; ``coupling`` 0 (no gc), 1
(a scalar's) or 2 (a plane's).  It returns ``(gd, gV, gc, gE)``: (K, n),
(K, n, r), () or (K, n - 1), (K, J), each empty where not asked for.
:func:`tlr_param_grads` puts ``solve``'s tensors into it, or says that it
cannot.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from xitorch_tpu_torch.ops import _build
from xitorch_tpu_torch.ops.tlr_residual import _flat, _stride
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["tlr_param_grads", "tlr_grad_cuda", "tlr_grad_plain", "fits_tlr_grad"]

# kE * kMaxThreads and the largest rank of csrc/tlr_grad.cu
_MAX_N = 4096
_MAX_RANK = 8

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "tlr_grad_f32": [_P] * 9 + [_LL, _LL] + [ctypes.c_int] * 3 + [_LL] * 5 + [_P],
    "tlr_grad_slots": [],
}
# the launches' scratch, one a (device, stream): the ticket word (the
# kernel's last block sets it back to 0) and the blocks' partial sums of a
# scalar coupling's gradient, one float for each of the most blocks the
# library launches on the device
_SCRATCH: dict = {}


def fits_tlr_grad(n: int, r: int) -> bool:
    """Whether the kernel takes systems of size n with a low-rank factor of
    rank r (0: no V, or no gradient to it)."""
    return 1 <= n <= _MAX_N and 0 <= r <= _MAX_RANK


def tlr_grad_plain(lam: torch.Tensor, x: torch.Tensor, V: Optional[torch.Tensor],
                   want_d: bool, coupling: int, want_e: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(gd, gV, gc, gE)`` in plain PyTorch, by the closed form (module
    docstring); the low-rank contractions in IEEE float32."""
    gd = -(lam * x).sum(1) if want_d else x.new_empty(0)
    gV = x.new_empty(0)
    if V is not None:
        p = einsum_hi("knq,kjn->kjq", V, x)
        q = einsum_hi("knq,kjn->kjq", V, lam)
        gV = -(einsum_hi("kjn,kjq->knq", lam, p) + einsum_hi("kjn,kjq->knq", x, q))
    gc = x.new_empty(0)
    if coupling:
        bond = lam[..., :-1] * x[..., 1:] + lam[..., 1:] * x[..., :-1]
        gc = -bond.sum() if coupling == 1 else -bond.sum(1)
    gE = (lam * x).sum(-1) if want_e else x.new_empty(0)
    return gd, gV, gc, gE


def _rows_ok(lam, x, V) -> bool:
    # the kernel reads each row of lam and x, and each system's (n, r)
    # block of V, as contiguous memory
    return (lam[0, 0].is_contiguous() and x[0, 0].is_contiguous()
            and (V is None or V[0].is_contiguous()))


def _scratch(lib, device: torch.device):
    # (ticket word, partial sums) of the current stream on device
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _SCRATCH:
        slots = lib.tlr_grad_slots()
        if slots < 1:
            raise RuntimeError("tlr_grad_cuda: the device's SM count could not be read")
        _SCRATCH[key] = (torch.zeros(1, dtype=torch.int32, device=device),
                         torch.empty(slots, dtype=torch.float32, device=device))
    return _SCRATCH[key]


def _outputs(x: torch.Tensor, r: int, want_d: bool, coupling: int, want_e: bool):
    # (gd, gV, gc, gE), allocated as the kernel writes them
    K, J, n = x.shape
    gd = x.new_empty(K, n) if want_d else x.new_empty(0)
    gV = x.new_empty(K, n, r) if r else x.new_empty(0)
    gc = x.new_empty(()) if coupling == 1 else x.new_empty(K, n - 1) if coupling else \
        x.new_empty(0)
    gE = x.new_empty(K, J) if want_e else x.new_empty(0)
    return gd, gV, gc, gE


def tlr_grad_cuda(lam: torch.Tensor, x: torch.Tensor, V: Optional[torch.Tensor],
                  want_d: bool, coupling: int, want_e: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the gradient kernel on CUDA float32 tensors in the operator's
    layout (module docstring); returns ``(gd, gV, gc, gE)`` on the card,
    without a synchronise."""
    K, J, n = x.shape
    r = 0 if V is None else V.shape[-1]
    for name, t, shape in (("lam", lam, (K, J, n)), ("V", V, (K, n, r))):
        if t is not None and tuple(t.shape) != shape:
            raise RuntimeError("tlr_grad_cuda: %s must be %s (got %s)"
                               % (name, shape, tuple(t.shape)))
    present = [t for t in (lam, x, V) if t is not None]
    if any(not t.is_cuda or t.dtype != torch.float32 or t.device != x.device
           for t in present):
        raise RuntimeError("tlr_grad_cuda: float32 CUDA tensors on one device only")
    if coupling not in (0, 1, 2):
        raise RuntimeError("tlr_grad_cuda: coupling must be 0, 1 or 2 (got %r)" % (coupling,))
    if K * J == 0 or not fits_tlr_grad(n, r) or not _rows_ok(lam, x, V):
        raise RuntimeError(
            "tlr_grad_cuda: K=%d, J=%d, n=%d, rank %d, or a row that is not contiguous, "
            "is outside the kernel (n <= %d, rank <= %d)" % (K, J, n, r, _MAX_N, _MAX_RANK))
    # a coupling's gradient needs a bond: with n = 1 it is 0
    c_mode = coupling if n > 1 else 0
    gd, gV, gc, gE = _outputs(x, r, want_d, coupling, want_e)
    if coupling and not c_mode:
        gc.zero_()
    lib = _build.load("tlr_grad", _SIGNATURES)

    def ptr(t, want=True):
        return t.data_ptr() if want and t is not None and t.numel() else None

    with torch.cuda.device(x.device):
        counter, partial = _scratch(lib, x.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tlr_grad_f32(
            ptr(lam), ptr(x), ptr(V), ptr(gd, want_d), ptr(gV), ptr(gc, c_mode > 0),
            ptr(gE, want_e), partial.data_ptr(), counter.data_ptr(), K, J, n, r, c_mode,
            _stride(lam, 0), _stride(lam, 1), _stride(x, 0), _stride(x, 1), _stride(V, 0),
            stream)
    _build.check(rc, "tlr_grad_cuda")
    tlr_grad_cuda.launches += 1
    return gd, gV, gc, gE


tlr_grad_cuda.launches = 0


@torch.library.custom_op("xitorch_tpu_torch::tlr_grad", mutates_args=(), device_types="cpu")
def _tlr_grad_op(lam: torch.Tensor, x: torch.Tensor, V: Optional[torch.Tensor],
                 want_d: bool, coupling: int, want_e: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients as an operator: :func:`tlr_grad_cuda` on CUDA tensors,
    :func:`tlr_grad_plain` on CPU tensors."""
    return tlr_grad_plain(lam, x, V, want_d, coupling, want_e)


@_tlr_grad_op.register_kernel("cuda")
def _(lam, x, V, want_d, coupling, want_e):
    return tlr_grad_cuda(lam, x, V, want_d, coupling, want_e)


@_tlr_grad_op.register_fake
def _(lam, x, V, want_d, coupling, want_e):
    return _outputs(x, 0 if V is None else V.shape[-1], want_d, coupling, want_e)


def tlr_param_grads(d: torch.Tensor, c: torch.Tensor, V: Optional[torch.Tensor],
                    x: torch.Tensor, lam: torch.Tensor, E: Optional[torch.Tensor],
                    need_d: bool, need_c: bool, need_V: bool, need_E: bool
                    ) -> Optional[tuple]:
    """The gradients ``(gE, gd, gc, gV)`` of ``-lam^T (A - E) x`` for
    ``solve``'s tensors: ``d``, ``c`` and ``V`` of a
    :class:`TridiagLowRankOperator`, the solution ``x`` and adjoint solution
    ``lam`` (*batch, n, ncols), the shifts ``E`` (*BE, ncols) or None; each
    in its tensor's shape where asked for, else None.  None where the
    kernel's layout does not take them: n or V's rank outside
    :func:`fits_tlr_grad`, a tensor that needs a gradient and is broadcast
    along the system axis (its gradient would be a sum over systems), a
    column of x or lam or a row of V not contiguous along n, or nothing to
    compute."""
    n, J = x.shape[-2:]
    batch = tuple(x.shape[:-2])
    K = math.prod(batch)
    coupled = c.ndim == 0 or c.shape[-1] != 0
    r = V.shape[-1] if need_V else 0
    if K * J == 0 or not fits_tlr_grad(n, r):
        return None
    # a gradient with the solution's batch: no broadcast to sum over
    if (need_d and tuple(d.shape) != (*batch, n)) \
            or (need_V and tuple(V.shape) != (*batch, n, r)) \
            or (need_E and tuple(E.shape) != (*batch, J)) \
            or (need_c and coupled and c.ndim > 0 and tuple(c.shape) != (*batch, n - 1)):
        return None
    coupling = 0 if not (need_c and coupled) else (1 if c.ndim == 0 else 2)
    if not (need_d or need_V or need_E or coupling):
        return None
    xr = _flat(x.transpose(-1, -2), (*batch, J, n), (K, J, n))
    lr = _flat(lam.transpose(-1, -2), (*batch, J, n), (K, J, n))
    Vr = _flat(V, (*batch, n, r), (K, n, r)) if need_V else None
    if xr is None or lr is None or (need_V and Vr is None) or not _rows_ok(lr, xr, Vr):
        return None
    gd, gV, gc, gE = _tlr_grad_op(lr, xr, Vr, need_d, coupling, need_E)
    return (gE.view(E.shape) if need_E else None,
            gd.view(d.shape) if need_d else None,
            (gc.view(c.shape) if coupling else torch.zeros_like(c)) if need_c else None,
            gV.view(V.shape) if need_V else None)
