"""Contractions in IEEE float32 and Cholesky-QR (counterpart of
``einsum_hi``/``dot_hi``/``tallqr`` in xitorch_tpu/utils/tensor.py).

The JAX package runs every solver-internal contraction at HIGHEST
precision, because the TPU's default bf16 multiplies floor residuals far
above any useful tolerance.  On an NVIDIA card the same trap is TF32,
which PyTorch enables for float32 matrix products when the process asks
for ``torch.set_float32_matmul_precision("high")``: it keeps about three
decimal digits.  :func:`ieee_f32` sets the precision to "highest" for the
duration of a contraction and restores the caller's setting after it.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch

__all__ = ["einsum_hi", "dot_hi", "ieee_f32", "tallqr"]


@contextmanager
def ieee_f32():
    """Run float32 matrix products inside the block without TF32."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def einsum_hi(spec: str, *args: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in IEEE float32 (never TF32)."""
    with ieee_f32():
        return torch.einsum(spec, *args)


def dot_hi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in IEEE float32 (never TF32)."""
    with ieee_f32():
        return torch.matmul(a, b)


def tallqr(V: torch.Tensor, MV: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """QR for tall-skinny matrices by Cholesky of the Gram matrix.

    V: (*B, na, nguess); MV: optional (*B, na, nguess) for M-orthogonality.
    Returns (Q, R) with M-orthonormal columns of Q.  The Gram product runs
    in IEEE float32.  Where the Gram matrix is not numerically positive
    definite the factor is filled with NaN (no error is raised): the
    iterative eigensolvers detect such a round and keep their previous
    iterate.
    """
    if MV is None:
        MV = V
    VTV = dot_hi(V.mH, MV)  # (*B, ng, ng)
    eps = torch.finfo(V.dtype).eps
    eye = torch.eye(VTV.shape[-1], dtype=VTV.dtype, device=VTV.device)
    trace = torch.diagonal(VTV.real, dim1=-2, dim2=-1).sum(-1)
    L, info = torch.linalg.cholesky_ex(VTV + eps * trace[..., None, None] * eye)
    L = torch.where((info != 0)[..., None, None], float("nan"), L)
    R = L.mH  # upper: R^H R = V^H M V
    # Q = V R^-1 by a triangular solve of R^H Q^H = V^H
    Q = torch.linalg.solve_triangular(L, V.mH, upper=False).mH
    return Q, R
