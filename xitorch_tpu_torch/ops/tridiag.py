"""Batched tridiagonal (Thomas) solve (counterpart of xitorch_tpu/ops/tridiag.py).

Layout is the callers' ``(K, n)``: K independent systems, each row
contiguous.  On a CUDA tensor :func:`tridiag_solve_kernel` launches the
hand-written kernel in ``csrc/tridiag.cu`` (:func:`thomas_cuda`), or
raises; on a CPU tensor it runs :func:`thomas_plain`, the same sweep in
PyTorch.  The kernel stages the rows of 32 systems through shared memory,
so it reads and writes this layout with no transposes around it.

Differentiability: :func:`tridiag_solve` wraps the solve in a
``torch.autograd.Function`` whose backward is the transposed solve (the
same kernel with dl and du swapped and shifted by one) plus the
parameter gradients of the matvec, at any order.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from xitorch_tpu_torch.ops import _build

__all__ = ["tridiag_solve", "tridiag_matvec", "tridiag_solve_kernel",
           "thomas_cuda", "thomas_plain"]

_P = ctypes.c_void_p
_SIGNATURES = {
    "thomas_f32": [_P] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    "thomas_f64": [_P] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_double, _P],
}

# systems a block of csrc/tridiag.cu
_SYS = 32


def check_device(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device (the kernel) or the CPU (the
    plain version): the devices the kernels' operators run on."""
    if not (t.is_cuda or t.device.type == "cpu"):
        raise RuntimeError("xitorch_tpu_torch kernels take CUDA or CPU tensors "
                           "(got a tensor on %s)" % t.device)


def tridiag_matvec(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y_i = dl_i x_{i-1} + d_i x_i + du_i x_{i+1} along the last dim.
    Convention: dl[..., 0] and du[..., -1] are ignored (treated as 0)."""
    y = d * x
    y = y + F.pad(dl[..., 1:] * x[..., :-1], (1, 0))
    y = y + F.pad(du[..., :-1] * x[..., 1:], (0, 1))
    return y


def thomas_plain(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                 b: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch Thomas sweep on ``(K, n)`` tensors, vectorised over K:
    the same recurrence and zero-pivot rule as the kernel."""
    n = b.shape[-1]
    cp = torch.empty_like(b)
    x = torch.empty_like(b)
    m = torch.where(d[:, 0] == 0, eps, d[:, 0])
    cp[:, 0] = du[:, 0] / m
    x[:, 0] = b[:, 0] / m
    for i in range(1, n):
        m = d[:, i] - dl[:, i] * cp[:, i - 1]
        m = torch.where(m == 0, eps, m)
        cp[:, i] = du[:, i] / m
        x[:, i] = (b[:, i] - dl[:, i] * x[:, i - 1]) / m
    for i in range(n - 2, -1, -1):
        x[:, i] = x[:, i] - cp[:, i] * x[:, i + 1]
    return x


def _check_panels(what, panels):
    b = panels[-1]
    if b.dtype not in (torch.float32, torch.float64):
        raise RuntimeError("%s: float32 or float64 only (got %s)" % (what, b.dtype))
    for t in panels:
        if not t.is_cuda or t.dtype != b.dtype or t.shape != b.shape \
                or not t.is_contiguous() or t.device != b.device:
            raise RuntimeError(
                "%s: dl, d, du, b must be contiguous CUDA tensors of one dtype, "
                "device and 2-D shape" % what)
    if b.dim() != 2:
        raise RuntimeError("%s: expected 2-D tensors (got %s)" % (what, tuple(b.shape)))


def thomas_cuda(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                b: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the Thomas kernel on contiguous ``(K, n)`` CUDA tensors of one
    dtype (float32 or float64).  The kernel keeps cp and the forward sweep's
    x in a device-memory scratch of 2 n values a system."""
    _check_panels("thomas_cuda", (dl, d, du, b))
    K, n = b.shape
    x = torch.empty_like(b)
    ws = torch.empty(2 * -(-K // _SYS) * _SYS * n, dtype=b.dtype, device=b.device)
    lib = _build.load("tridiag", _SIGNATURES)
    fn = lib.thomas_f32 if b.dtype == torch.float32 else lib.thomas_f64
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
                x.data_ptr(), ws.data_ptr(), n, K, eps, stream)
    _build.check(rc, "thomas_cuda")
    thomas_cuda.launches += 1
    return x


thomas_cuda.launches = 0


@torch.library.custom_op("xitorch_tpu_torch::thomas", mutates_args=(), device_types="cpu")
def _thomas_op(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor,
           eps: float) -> torch.Tensor:
    """The Thomas solve as an operator: :func:`thomas_cuda` on CUDA tensors,
    :func:`thomas_plain` on CPU tensors, so that ``torch.export`` can trace
    through a launch."""
    return thomas_plain(dl, d, du, b, eps)


@_thomas_op.register_kernel("cuda")
def _(dl, d, du, b, eps):
    return thomas_cuda(dl, d, du, b, eps)


@_thomas_op.register_fake
def _(dl, d, du, b, eps):
    return torch.empty_like(b)


def tridiag_solve_kernel(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                         b: torch.Tensor, *, eps: float = 0.0) -> torch.Tensor:
    """Raw solve (no autograd) of K independent tridiagonal systems; the
    counterpart of ``tridiag_solve_pallas``.

    All inputs ``(*B, n)`` (diagonals may broadcast against b's batch);
    batch dims flatten into the K axis.  ``dl[..., 0]`` and ``du[..., -1]``
    are ignored.  ``eps`` replaces a zero pivot (default: the dtype's
    smallest normal number).
    """
    n = b.shape[-1]
    batch = torch.broadcast_shapes(dl.shape[:-1], d.shape[:-1],
                                   du.shape[:-1], b.shape[:-1])
    K = math.prod(batch)
    if K == 0 or n == 0:
        return torch.zeros((*batch, n), dtype=b.dtype, device=b.device)

    def flat(a):  # (K, n); a copy only where a is broadcast or strided
        return a.expand(*batch, n).reshape(K, n).contiguous()

    if eps == 0.0:
        eps = float(torch.finfo(b.dtype).tiny)
    check_device(b)
    x = _thomas_op(*map(flat, (dl, d, du, b)), eps)
    return x.reshape(*batch, n)


class _TridiagSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dl, d, du, b):
        x = tridiag_solve_kernel(dl, d, du, b)
        ctx.save_for_backward(dl, d, du, x)
        return x

    @staticmethod
    def backward(ctx, g):
        dl, d, du, x = ctx.saved_tensors
        # T^T: sub-diag_i = du_{i-1}, super-diag_i = dl_{i+1}
        dlT = torch.cat([torch.zeros_like(du[..., :1]), du[..., :-1]], dim=-1)
        duT = torch.cat([dl[..., 1:], torch.zeros_like(dl[..., :1])], dim=-1)
        lam = tridiag_solve(dlT, d, duT, g)
        need = ctx.needs_input_grad
        grads = [None, None, None]
        wrt = [i for i in range(3) if need[i]]
        if wrt:
            create = torch.is_grad_enabled()
            with torch.enable_grad():
                # stand-ins of the diagonals: the derivative of T x with x
                # held fixed (x's own graph leads to the originals)
                diags = [a.view_as(a) for a in (dl, d, du)]
                y = tridiag_matvec(*diags, x)
                gs = torch.autograd.grad(y, [diags[i] for i in wrt], -lam,
                                         create_graph=create, allow_unused=True)
            for i, gi in zip(wrt, gs):
                grads[i] = torch.zeros_like(x) if gi is None else gi
        return grads[0], grads[1], grads[2], lam if need[3] else None


def tridiag_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Differentiable batched tridiagonal solve ``T x = b``.

    Gradients (any order) to b and to the diagonals by the implicit rule:
    the backward solves ``T^T lam = g`` with the same kernel (dl and du
    swapped and shifted by one), then differentiates ``-lam . T x``.
    """
    batch = torch.broadcast_shapes(dl.shape[:-1], d.shape[:-1],
                                   du.shape[:-1], b.shape[:-1])
    n = b.shape[-1]
    dl, d, du, b = (a.expand(*batch, n) for a in (dl, d, du, b))
    return _TridiagSolve.apply(dl, d, du, b)
