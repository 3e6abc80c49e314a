"""Carry operator data across from the JAX package.

:func:`operator_from_numpy` builds the port's operator from numpy arrays
keyed by the JAX operator's ``_getparamnames`` (``np.asarray(A.d)`` and so
on), so both packages compute on identical inputs; :func:`pencil_from_numpy`
builds the dense hermitian operator A, and the metric M of a generalized
pencil ``(A, M)``, that ``symeig`` takes; :func:`deq_params_from_numpy` and
:func:`node_params_from_numpy` carry a DEQ's or a neural ODE's parameters
across.  This module imports no JAX:
the arrays are plain numpy.  The tensors go to the card unless the caller
names another device (``device="cpu"``, as the CPU tests do); with no card
and no device named, both functions raise.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from xitorch_tpu_torch._core.kron import KronOperator, KronSumOperator
from xitorch_tpu_torch._core.linop import LinearOperator, MatrixLinearOperator
from xitorch_tpu_torch._core.structured import (
    BandedLowRankOperator, TridiagLowRankOperator,
)

__all__ = ["operator_from_numpy", "pencil_from_numpy", "deq_params_from_numpy",
           "node_params_from_numpy"]

_KINDS = ("TridiagLowRankOperator", "BandedLowRankOperator", "MatrixLinearOperator",
          "KronOperator", "KronSumOperator")


def _device(device) -> torch.device:
    """``device``, or the current CUDA device where it is None."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's operators go to the card unless "
                           "a device is named (device=\"cpu\")")
    return torch.device("cuda", torch.cuda.current_device())


def operator_from_numpy(kind: str, params: Mapping[str, object], device=None,
                        dtype: Optional[torch.dtype] = None, *,
                        offsets: Optional[Sequence[int]] = None,
                        is_hermitian: Optional[bool] = None) -> LinearOperator:
    """Build the port's operator from the JAX operator's parameter arrays.

    ``kind``: "TridiagLowRankOperator" (params ``d``, ``c``, optional
    ``V``), "BandedLowRankOperator" (``d``, ``band_vals`` — a sequence of
    arrays, one per offset in ``offsets`` — optional ``V``) or
    "MatrixLinearOperator" (``mat``; ``is_hermitian`` as in
    ``LinearOperator.m``), "KronOperator" or "KronSumOperator" (``factors``,
    a sequence of square arrays; ``is_hermitian`` as the class takes it, so
    ``None`` means not hermitian for raw arrays).  ``dtype`` defaults to
    each array's own; complex arrays (complex hermitian operators and
    pencils) come across as complex tensors, and a real ``dtype`` for a
    complex array is an error.  ``device``: the current CUDA device where
    None (a RuntimeError without one).
    """
    device = _device(device)

    def t(a):
        if a is None:
            return None
        a = np.asarray(a)
        if np.iscomplexobj(a) and dtype is not None and not dtype.is_complex:
            raise ValueError("a complex array cannot be carried across as %s: "
                             "pass a complex dtype or none" % (dtype,))
        return torch.tensor(a, dtype=dtype, device=device)  # a copy

    if kind == "TridiagLowRankOperator":
        c = params.get("c")
        if c is not None and np.asarray(c).size == 0:
            c = None  # the JAX operator's no-coupling sentinel
        return TridiagLowRankOperator(t(params["d"]), t(c), t(params.get("V")))
    if kind == "BandedLowRankOperator":
        vals = list(params.get("band_vals", ()))
        if offsets is None or len(offsets) != len(vals):
            raise ValueError("BandedLowRankOperator needs one offset per band "
                             "value (offsets=%r, %d bands)" % (offsets, len(vals)))
        bands = {int(o): t(v) for o, v in zip(offsets, vals)}
        return BandedLowRankOperator(t(params["d"]), bands, t(params.get("V")))
    if kind == "MatrixLinearOperator":
        mat = t(params["mat"])
        if is_hermitian is None:
            return LinearOperator.m(mat)
        return MatrixLinearOperator(mat, is_hermitian)
    if kind in ("KronOperator", "KronSumOperator"):
        if not params.get("factors"):
            raise ValueError("%s needs its factors (params['factors'], a sequence "
                             "of square arrays)" % kind)
        cls = KronOperator if kind == "KronOperator" else KronSumOperator
        return cls(*(t(f) for f in params["factors"]), is_hermitian=is_hermitian)
    raise ValueError("unknown operator kind %r (known: %s)"
                     % (kind, ", ".join(_KINDS)))


def pencil_from_numpy(a, m=None, device=None, dtype: Optional[torch.dtype] = None
                      ) -> Tuple[LinearOperator, Optional[LinearOperator]]:
    """Dense hermitian operators of the eigenproblem ``A X = M X E`` from
    numpy arrays: ``(A, M)`` with ``M = None`` for the standard problem.
    Both are declared hermitian (``LinearOperator.m(..., is_hermitian=True)``
    on the JAX side), so nothing is inferred from the values.  ``device`` as
    in :func:`operator_from_numpy`."""
    device = _device(device)
    A = operator_from_numpy("MatrixLinearOperator", {"mat": a}, device, dtype,
                            is_hermitian=True)
    M = None if m is None else operator_from_numpy(
        "MatrixLinearOperator", {"mat": m}, device, dtype, is_hermitian=True)
    return A, M


def _model_params(cls, params, device, dtype):
    """``cls`` (a NamedTuple of tensors) from the JAX model's parameters as
    numpy arrays: a NamedTuple or mapping keyed by the field names, or a
    sequence in field order.  Leaf tensors that require grad."""
    device = _device(device)
    if hasattr(params, "_asdict"):
        params = params._asdict()
    if isinstance(params, Mapping):
        missing = [f for f in cls._fields if f not in params]
        if missing:
            raise ValueError("%s needs the fields %s" % (cls.__name__, ", ".join(missing)))
        params = [params[f] for f in cls._fields]
    if len(params) != len(cls._fields):
        raise ValueError("%s has %d fields, got %d arrays"
                         % (cls.__name__, len(cls._fields), len(params)))
    return cls(*(torch.tensor(np.asarray(p), dtype=dtype, device=device).requires_grad_()
                 for p in params))


def deq_params_from_numpy(params, device=None, dtype: Optional[torch.dtype] = None):
    """The port's :class:`~xitorch_tpu_torch.models.DEQParams` from the JAX
    package's (``W``, ``U``, ``b``, ``Wout``, ``bout`` as numpy arrays, in a
    NamedTuple, a mapping or a sequence), so both packages compute the same
    model.  ``device`` as in :func:`operator_from_numpy`."""
    from xitorch_tpu_torch.models.deq import DEQParams

    return _model_params(DEQParams, params, device, dtype)


def node_params_from_numpy(params, device=None, dtype: Optional[torch.dtype] = None):
    """The port's :class:`~xitorch_tpu_torch.models.NODEParams` from the JAX
    package's (``W1``, ``b1``, ``W2``, ``b2``, ``Win``, ``Wout``, ``bout``),
    as :func:`deq_params_from_numpy`."""
    from xitorch_tpu_torch.models.node import NODEParams

    return _model_params(NODEParams, params, device, dtype)
