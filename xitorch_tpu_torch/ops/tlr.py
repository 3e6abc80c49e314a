"""The card route of solves with a tridiagonal-plus-low-rank operator
``A = diag(d) + T(c) + V V^T`` (no counterpart in xitorch_tpu, which
leaves both jobs to XLA): the eager convergence check's verdict and the
backward's first-order gradients of the operator's parameters.

The check.  ``linalg.solve`` asks, over every column j of every system k,
whether ``||(A - e_j I) x - b|| > 10 max(rtol ||b||, atol)``, and queues
the verdict ``[failed, max resid, max stop]``.  On CUDA float32 tensors
:func:`tlr_residual_cuda` computes it in one launch of
``csrc/tlr_residual.cu``, reading x, b, d, c and V once; on CPU tensors
:func:`tlr_residual_plain` computes it with the same PyTorch operations as
the generic check.

The gradients.  The backward needs the gradient of ``-lam^T (A - E) x`` to
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

Both kernels read one layout, whose rows are (system, column) pairs:
``x``, ``b`` and ``lam`` (K, J, n), each row contiguous; ``d`` (K, n);
``c`` (K, n - 1) (a scalar coupling expanded, stride 0) or None; ``V`` (K,
n, r), each system's block row-major, or None; ``e`` (K, J) or None.  The
system axis of d, c, V and e, and of b, may be a broadcast (stride 0):
nothing is copied.  :func:`tlr_rows` puts ``solve``'s tensors into it, or
says that it cannot; :func:`tlr_residual_check` and :func:`tlr_param_grads`
are ``solve``'s two entries.  The operator ``xitorch_tpu_torch::tlr_grad``
takes ``want_d``, ``want_e`` (whether gd and gE are asked for) and
``coupling`` 0 (no gc), 1 (a scalar's) or 2 (a plane's), and returns
``(gd, gV, gc, gE)``: (K, n), (K, n, r), () or (K, n - 1), (K, J), each
empty where not asked for (gV where V is None).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from xitorch_tpu_torch.ops import _build
from xitorch_tpu_torch.utils.tensor import einsum_hi

__all__ = ["fits_tlr", "tlr_rows", "residual_verdict", "tlr_residual_check",
           "tlr_residual_cuda", "tlr_residual_plain", "tlr_param_grads", "tlr_grad_cuda",
           "tlr_grad_plain"]

# kE * kMaxThreads and the largest rank of csrc/tlr_common.cuh's kernels
_MAX_N = 4096
_MAX_RANK = 8

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_RESIDUAL_SIGNATURES = {
    "tlr_residual_f32": [_P] * 9 + [_LL, _LL] + [ctypes.c_int] * 3 + [_LL] * 9
    + [ctypes.c_float, ctypes.c_float, _P],
    "tlr_slots": [],
}
_GRAD_SIGNATURES = {
    "tlr_grad_f32": [_P] * 9 + [_LL, _LL] + [ctypes.c_int] * 3 + [_LL] * 5 + [_P],
    "tlr_slots": [],
}
# both kernels' scratch, one a (device, stream): the ticket word (each
# kernel's last block sets it back to 0) and the blocks' partials, 3 floats
# for each of the most blocks a launch holds on the device (the check's
# verdicts; the gradients use one float a block, a scalar coupling's sum).
# The launches on a stream run in turn, so they share it.
_SCRATCH: dict = {}


def fits_tlr(n: int, r: int) -> bool:
    """Whether the kernels take systems of size n with a low-rank factor of
    rank r (0: no V, or no gradient to it)."""
    return 1 <= n <= _MAX_N and 0 <= r <= _MAX_RANK


def _stride(t: Optional[torch.Tensor], dim: int) -> int:
    # a dimension of size 1 is read at index 0 only: its stride is moot
    if t is None or t.shape[dim] == 1:
        return 0
    return t.stride(dim)


def _rows_ok(x, y, d, c, V) -> bool:
    # the kernels read each row of x, y and d, and each system's (n, r)
    # block of V, as contiguous memory; a coupling plane with stride 1 or 0
    # (a value a system)
    return (x[0, 0].is_contiguous() and y[0, 0].is_contiguous()
            and (d is None or d[0].is_contiguous())
            and (V is None or V[0].is_contiguous())
            and (c is None or _stride(c, -1) in (0, 1)))


def _flat(t: torch.Tensor, shape, flat) -> Optional[torch.Tensor]:
    # t broadcast to shape, then viewed as flat; None where no view (a copy)
    # gives it
    try:
        return t.expand(shape).view(flat)
    except RuntimeError:
        return None


def tlr_rows(x: torch.Tensor, y: torch.Tensor, d: Optional[torch.Tensor] = None,
             c: Optional[torch.Tensor] = None, V: Optional[torch.Tensor] = None,
             E: Optional[torch.Tensor] = None) -> Optional[tuple]:
    """``solve``'s tensors in the kernels' layout (module docstring),
    ``(x, y, d, c, V, e)``: the columns of ``x`` and ``y`` (*batch, n, J)
    as (K, J, n) rows, and ``d`` (*, n), the coupling ``c`` (a scalar, a
    (*, n - 1) plane or (0,)), ``V`` (*, n, r) and the shifts ``E`` (*, J)
    each in its view, None where given None (or a coupling that couples
    nothing).  None where no view takes them without a copy: n or the rank
    outside :func:`fits_tlr`, a column of x or y, d, a coupling plane or a
    row of V not contiguous along n, a broadcast that no stride expresses,
    or nothing to read."""
    n, J = x.shape[-2:]
    batch = tuple(x.shape[:-2])
    K = math.prod(batch)
    r = 0 if V is None else V.shape[-1]
    if K * J == 0 or not fits_tlr(n, r):
        return None
    xr = _flat(x.transpose(-1, -2), (*batch, J, n), (K, J, n))
    yr = _flat(y.transpose(-1, -2), (*batch, J, n), (K, J, n))
    dr = None if d is None else _flat(d, (*batch, n), (K, n))
    cr = None
    if c is not None and n > 1 and c.ndim == 0:
        cr = c.expand(K, n - 1)
    elif c is not None and n > 1 and c.shape[-1] == n - 1:
        cr = _flat(c, (*batch, n - 1), (K, n - 1))
        if cr is None:
            return None
    Vr = None if V is None else _flat(V, (*batch, n, r), (K, n, r))
    er = None if E is None else _flat(E, (*batch, J), (K, J))
    if xr is None or yr is None or (d is not None and dr is None) \
            or (V is not None and Vr is None) or (E is not None and er is None) \
            or not _rows_ok(xr, yr, dr, cr, Vr):
        return None
    return xr, yr, dr, cr, Vr, er


def _scratch(lib, device: torch.device):
    # (ticket word, partials) of the current stream on device
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _SCRATCH:
        slots = lib.tlr_slots()
        if slots < 1:
            raise RuntimeError("xitorch_tpu_torch.ops.tlr: the device's SM count could not be read")
        _SCRATCH[key] = (torch.zeros(1, dtype=torch.int32, device=device),
                         torch.empty(3 * slots, dtype=torch.float32, device=device))
    return _SCRATCH[key]


def _check_layout(what: str, x, y, y_name: str, d=None, c=None, V=None, e=None) -> None:
    # the launchers' checks: the layout's shapes (x (K, J, n) sets them),
    # float32 CUDA tensors on one device, the window, contiguous rows
    K, J, n = x.shape
    r = 0 if V is None else V.shape[-1]
    for name, t, shape in ((y_name, y, (K, J, n)), ("d", d, (K, n)), ("c", c, (K, n - 1)),
                           ("V", V, (K, n, r)), ("e", e, (K, J))):
        if t is not None and tuple(t.shape) != shape:
            raise RuntimeError("%s: %s must be %s (got %s)" % (what, name, shape, tuple(t.shape)))
    if any(not t.is_cuda or t.dtype != torch.float32 or t.device != x.device
           for t in (x, y, d, c, V, e) if t is not None):
        raise RuntimeError("%s: float32 CUDA tensors on one device only" % what)
    if K * J == 0 or not fits_tlr(n, r) or not _rows_ok(x, y, d, c, V):
        raise RuntimeError(
            "%s: K=%d, J=%d, n=%d, rank %d, or a row that is not contiguous, is outside "
            "the kernel (n <= %d, rank <= %d)" % (what, K, J, n, r, _MAX_N, _MAX_RANK))


# ---------------------------------------------------------------- the check


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


def tlr_residual_cuda(x: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
                      c: Optional[torch.Tensor], V: Optional[torch.Tensor],
                      e: Optional[torch.Tensor], rtol: float, atol: float) -> torch.Tensor:
    """Launch the residual kernel on CUDA float32 tensors in the layout of
    the module docstring; returns the (3,) verdict on the card, without a
    synchronise."""
    _check_layout("tlr_residual_cuda", x, b, "b", d, c, V, e)
    K, J, n = x.shape
    r = 0 if V is None else V.shape[-1]
    # a coupling read once a system (a scalar expanded) or as a plane of n - 1
    c_mode = 0 if c is None or n == 1 else (1 if _stride(c, -1) == 0 else 2)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    lib = _build.load("tlr_residual", _RESIDUAL_SIGNATURES)

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


def tlr_residual_check(d: torch.Tensor, c: torch.Tensor, V: Optional[torch.Tensor],
                       x: torch.Tensor, B: torch.Tensor, E: Optional[torch.Tensor],
                       rtol: float, atol: float) -> Optional[torch.Tensor]:
    """The eager check's verdict for ``solve``'s tensors: ``d``, ``c`` and
    ``V`` of a :class:`TridiagLowRankOperator`, the solution ``x`` and
    right-hand side ``B`` (*batch, n, ncols), the shifts ``E`` (*BE, ncols)
    or None.  None where :func:`tlr_rows` does not take them."""
    rows = tlr_rows(x, B, d, c, V, E)
    if rows is None:
        return None
    return _tlr_residual_op(*rows, float(rtol), float(atol))


# ------------------------------------------------------------ the gradients


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
    """Launch the gradient kernel on CUDA float32 tensors in the layout of
    the module docstring; returns ``(gd, gV, gc, gE)`` on the card, without
    a synchronise."""
    if coupling not in (0, 1, 2):
        raise RuntimeError("tlr_grad_cuda: coupling must be 0, 1 or 2 (got %r)" % (coupling,))
    _check_layout("tlr_grad_cuda", x, lam, "lam", V=V)
    K, J, n = x.shape
    r = 0 if V is None else V.shape[-1]
    # a coupling's gradient needs a bond: with n = 1 it is 0
    c_mode = coupling if n > 1 else 0
    gd, gV, gc, gE = _outputs(x, r, want_d, coupling, want_e)
    if coupling and not c_mode:
        gc.zero_()
    lib = _build.load("tlr_grad", _GRAD_SIGNATURES)

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
    in its tensor's shape where asked for, else None.  None where
    :func:`tlr_rows` does not take x, lam and (asked for its gradient) V, a
    tensor that needs a gradient is broadcast along the system axis (its
    gradient would be a sum over systems), or nothing is asked for."""
    n, J = x.shape[-2:]
    batch = tuple(x.shape[:-2])
    coupled = c.ndim == 0 or c.shape[-1] != 0
    # a gradient with the solution's batch: no broadcast to sum over
    if (need_d and tuple(d.shape) != (*batch, n)) \
            or (need_V and tuple(V.shape) != (*batch, n, V.shape[-1])) \
            or (need_E and tuple(E.shape) != (*batch, J)) \
            or (need_c and coupled and c.ndim > 0 and tuple(c.shape) != (*batch, n - 1)):
        return None
    coupling = 0 if not (need_c and coupled) else (1 if c.ndim == 0 else 2)
    if not (need_d or need_V or need_E or coupling):
        return None
    rows = tlr_rows(x, lam, V=V if need_V else None)
    if rows is None:
        return None
    xr, lr, _, _, Vr, _ = rows
    gd, gV, gc, gE = _tlr_grad_op(lr, xr, Vr, need_d, coupling, need_E)
    return (gE.view(E.shape) if need_E else None,
            gd.view(d.shape) if need_d else None,
            (gc.view(c.shape) if coupling else torch.zeros_like(c)) if need_c else None,
            gV.view(V.shape) if need_V else None)
