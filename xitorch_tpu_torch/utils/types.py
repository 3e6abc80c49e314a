"""dtype maps between torch, numpy and strings (counterpart of
xitorch_tpu/utils/types.py, whose ``get_jax_dtype`` becomes
:func:`get_torch_dtype`)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_np_dtype", "get_torch_dtype", "get_complex_dtype", "get_real_dtype"]

_NP_FROM_TORCH = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.bfloat16: np.float32,  # numpy has no bfloat16; promote
    torch.float16: np.float16,
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.bool: np.bool_,
}


def get_np_dtype(dtype) -> np.dtype:
    """torch (or numpy / string) dtype -> numpy dtype."""
    d = get_torch_dtype(dtype)
    if d in _NP_FROM_TORCH:
        return np.dtype(_NP_FROM_TORCH[d])
    return np.dtype(str(d)[len("torch."):])


def get_torch_dtype(dtype) -> torch.dtype:
    """numpy / torch / string dtype (``"float64"``, ``"torch.float32"``,
    ``np.float32``, a JAX dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    s = str(dtype)
    if s.startswith("torch."):
        s = s[len("torch."):]
    else:
        s = np.dtype(dtype).name if not isinstance(dtype, str) else s
    d = getattr(torch, s, None)
    if not isinstance(d, torch.dtype):
        raise TypeError("no torch dtype for %r" % (dtype,))
    return d


def get_complex_dtype(dtype) -> torch.dtype:
    d = get_torch_dtype(dtype)
    if d.is_complex:
        return d
    return torch.complex64 if d == torch.float32 else torch.complex128


def get_real_dtype(dtype) -> torch.dtype:
    d = get_torch_dtype(dtype)
    if not d.is_complex:
        return d
    return torch.float32 if d == torch.complex64 else torch.float64
