"""Contractions in IEEE float32 (counterpart of ``einsum_hi``/``dot_hi`` in
xitorch_tpu/utils/tensor.py).

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

import torch

__all__ = ["einsum_hi", "dot_hi", "ieee_f32"]


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
