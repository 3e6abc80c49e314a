"""Matrix-free batched LinearOperator (counterpart of xitorch_tpu/_core/linop.py).

The public contract is the JAX package's: shape ``(*B, p, q)`` with
broadcastable batch dims, a required ``_mv`` and optional
``_mm/_rmv/_rmm/_fullmatrix``.  The state plumbing is PyTorch's:

* ``LinearOperator`` is a plain Python class.  A subclass names its
  differentiable tensors in ``_getparamnames(prefix)`` (dotted paths for
  nested operators, ``name[i]`` for tuple members), and
  :meth:`LinearOperator.getlinopparams` returns those tensors, which is
  what the implicit-gradient rules of :mod:`xitorch_tpu_torch.linalg`
  differentiate.
* ``rmv``/``rmm`` default to the exact adjoint through
  ``torch.autograd.grad`` of ``mv`` (differentiable again when gradients
  are enabled).
* ``mm`` defaults to ``mv`` applied to each column.
"""
from __future__ import annotations

import re
import warnings
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from xitorch_tpu_torch.utils.bcast import get_bcasted_dims
from xitorch_tpu_torch.utils.exceptions import GetSetParamsError
from xitorch_tpu_torch.utils.tensor import dot_hi, einsum_hi

__all__ = ["LinearOperator", "MatrixLinearOperator", "checklinop"]

_PATH_PART = re.compile(r"^([A-Za-z_]\w*)((?:\[\d+\])*)$")


def _resolve(obj, path: str):
    """Follow a ``_getparamnames`` path such as ``obj.band_vals[1]``."""
    for part in path.split("."):
        m = _PATH_PART.match(part)
        if m is None or not hasattr(obj, m.group(1)):
            raise GetSetParamsError(
                "_getparamnames declares unknown attribute %r" % path)
        obj = getattr(obj, m.group(1))
        for idx in re.findall(r"\[(\d+)\]", m.group(2)):
            obj = obj[int(idx)]
    return obj


def _assign(obj, path: str, value) -> None:
    """Set the attribute (or tuple member) a ``_getparamnames`` path names."""
    head, _, last = path.rpartition(".")
    parent = _resolve(obj, head) if head else obj
    m = _PATH_PART.match(last)
    idxs = [int(i) for i in re.findall(r"\[(\d+)\]", m.group(2))]
    if not idxs:
        setattr(parent, m.group(1), value)
        return
    if len(idxs) > 1:
        raise GetSetParamsError("nested indices are not supported: %r" % path)
    seq = getattr(parent, m.group(1))
    items = list(seq)
    items[idxs[0]] = value
    setattr(parent, m.group(1), type(seq)(items))


class LinearOperator:
    """Base class of a matrix-free linear operator with batched leading dims.

    A subclass must implement ``_mv(self, x)`` (matrix-vector product on the
    last dim) and, if it carries differentiable tensors, name them in
    ``_getparamnames(prefix)``.  Everything else (``mm``, ``rmv``, ``rmm``,
    ``fullmatrix``, adjoints, operator algebra) has generic implementations.
    """

    # ------------------------- construction -------------------------
    def __init__(self, shape: Sequence[int],
                 is_hermitian: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 device=None) -> None:
        if len(shape) < 2:
            raise RuntimeError("The shape must have at least 2 dimensions")
        if is_hermitian and shape[-1] != shape[-2]:
            raise RuntimeError("The object is indicated as Hermitian, but the shape is not square")
        self._shape = tuple(int(s) for s in shape)
        self._is_hermitian = bool(is_hermitian)
        self._dtype = dtype if dtype is not None else torch.float32
        self._device = torch.device(device) if device is not None else torch.device("cpu")

    @classmethod
    def m(cls, mat: torch.Tensor, is_hermitian: Optional[bool] = None) -> "MatrixLinearOperator":
        """Wrap an explicit (batched) matrix into a LinearOperator."""
        if is_hermitian is None:
            if mat.shape[-2] != mat.shape[-1]:
                is_hermitian = False
            else:
                is_hermitian = bool(torch.allclose(mat, mat.mH))
        return MatrixLinearOperator(mat, is_hermitian)

    # ------------------------- to be overridden -------------------------
    def _getparamnames(self, prefix: str = "") -> List[str]:
        """Paths of the tensors that parameterize this operator."""
        return []

    def _mv(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "LinearOperator subclass %s must implement _mv" % type(self).__name__)

    def _mm(self, x: torch.Tensor) -> torch.Tensor:
        # x: (*B, q, c) -> (*B2, p, c); default: mv on each column
        return torch.stack([self._bcast_mv(x[..., j]) for j in range(x.shape[-1])],
                           dim=-1)

    def _rmv(self, x: torch.Tensor) -> torch.Tensor:
        # default: exact adjoint of mv through autograd
        return self._adjoint_rmv(x)

    def _rmm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.rmv(x[..., j]) for j in range(x.shape[-1])], dim=-1)

    def _fullmatrix(self) -> torch.Tensor:
        nq = self.shape[-1]
        eye = torch.eye(nq, dtype=self.dtype, device=self.device)
        return self.mm(eye)  # (*B, p, q)

    # ------------------------- linear operator algebra -------------------------
    def matmul(self, b: "LinearOperator", is_hermitian: bool = False) -> "LinearOperator":
        """Compose two linear operators: ``self @ b``."""
        if self.shape[-1] != b.shape[-2]:
            raise RuntimeError(
                "Mismatch shape of matmul operation: %s and %s" % (self.shape, b.shape))
        return MatmulLinearOperator(self, b, is_hermitian=is_hermitian)

    def __matmul__(self, b: "LinearOperator") -> "LinearOperator":
        return self.matmul(b)

    def __add__(self, b: "LinearOperator") -> "LinearOperator":
        if not isinstance(b, LinearOperator):
            raise TypeError("Only LinearOperator can be added to LinearOperator")
        if self.shape[-2:] != b.shape[-2:]:
            raise RuntimeError(
                "Mismatch shape of add operation: %s and %s" % (self.shape, b.shape))
        # explicit operators fold to an explicit result
        if isinstance(self, MatrixLinearOperator) and \
                isinstance(b, MatrixLinearOperator):
            return MatrixLinearOperator(
                self.mat + b.mat, is_hermitian=self.is_hermitian and b.is_hermitian)
        return AddLinearOperator(self, b)

    def __sub__(self, b: "LinearOperator") -> "LinearOperator":
        if not isinstance(b, LinearOperator):
            raise TypeError("Only LinearOperator can be subtracted from LinearOperator")
        if self.shape[-2:] != b.shape[-2:]:
            raise RuntimeError(
                "Mismatch shape of sub operation: %s and %s" % (self.shape, b.shape))
        if isinstance(self, MatrixLinearOperator) and \
                isinstance(b, MatrixLinearOperator):
            return MatrixLinearOperator(
                self.mat - b.mat, is_hermitian=self.is_hermitian and b.is_hermitian)
        return AddLinearOperator(self, b, -1)

    def __rsub__(self, b):
        return b.__sub__(self)

    def __mul__(self, f: Union[int, float]):
        if not isinstance(f, (int, float)):
            raise TypeError("LinearOperator can only be multiplied with a scalar")
        if isinstance(self, MatrixLinearOperator):
            return MatrixLinearOperator(self.mat * f, is_hermitian=self.is_hermitian)
        return MulLinearOperator(self, f)

    def __rmul__(self, f):
        return self.__mul__(f)

    # ------------------------- public API -------------------------
    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """Matrix-vector product: x ``(*Bx, q)`` -> ``(*Bout, p)``."""
        if x.shape[-1] != self.shape[-1]:
            raise RuntimeError(
                "Cannot operate .mv on shape %s. Expected (...,%d)"
                % (tuple(x.shape), self.shape[-1]))
        return self._bcast_mv(x)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        """Matrix-matrix product: x ``(*Bx, q, c)`` -> ``(*Bout, p, c)``."""
        if x.shape[-2] != self.shape[-1]:
            raise RuntimeError(
                "Cannot operate .mm on shape %s. Expected (...,%d,*)"
                % (tuple(x.shape), self.shape[-1]))
        return self._mm(x)

    def rmv(self, x: torch.Tensor) -> torch.Tensor:
        """Adjoint matrix-vector product ``A^H x``: ``(*Bx, p)`` -> ``(*Bout, q)``."""
        if x.shape[-1] != self.shape[-2]:
            raise RuntimeError(
                "Cannot operate .rmv on shape %s. Expected (...,%d)"
                % (tuple(x.shape), self.shape[-2]))
        if self.is_hermitian:
            return self._bcast_mv(x)
        return self._rmv(x)

    def rmm(self, x: torch.Tensor) -> torch.Tensor:
        """Adjoint matrix-matrix product ``A^H x``: ``(*Bx, p, c)`` -> ``(*Bout, q, c)``."""
        if x.shape[-2] != self.shape[-2]:
            raise RuntimeError(
                "Cannot operate .rmm on shape %s. Expected (...,%d,*)"
                % (tuple(x.shape), self.shape[-2]))
        if self.is_hermitian:
            return self._mm(x)
        return self._rmm(x)

    def fullmatrix(self) -> torch.Tensor:
        return self._fullmatrix()

    def scipy_linalg_op(self):
        """The operator as a ``scipy.sparse.linalg.LinearOperator`` (each
        product runs here on the operator's device; vectors travel as
        numpy arrays through the host)."""
        import scipy.sparse.linalg

        def to_t(v) -> torch.Tensor:
            return torch.as_tensor(np.asarray(v), dtype=self.dtype, device=self.device)

        return scipy.sparse.linalg.LinearOperator(
            shape=tuple(self.shape[-2:]),
            matvec=lambda v: _np(self.mv(to_t(v))),
            rmatvec=lambda v: _np(self.rmv(to_t(v))),
            matmat=lambda m: _np(self.mm(to_t(m))),
            rmatmat=lambda m: _np(self.rmm(to_t(m))),
            dtype=np.dtype(str(self.dtype)[len("torch."):]))

    # ------------------------- properties -------------------------
    @property
    def H(self) -> "LinearOperator":
        """Hermitian conjugate (adjoint) of this operator."""
        if self.is_hermitian:
            return self
        return AdjointLinearOperator(self)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def is_hermitian(self) -> bool:
        return self._is_hermitian

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

    # capability flags of the reference's API
    @property
    def is_mv_implemented(self) -> bool:
        return True

    @property
    def is_getparamnames_implemented(self) -> bool:
        return True

    @property
    def is_fullmatrix_implemented(self) -> bool:
        """True when the subclass provides its own cheap ``_fullmatrix``
        (drives the exactsolve default)."""
        return type(self)._fullmatrix is not LinearOperator._fullmatrix

    # ------------------------- parameters -------------------------
    def getlinopparams(self) -> Tuple[torch.Tensor, ...]:
        """The operator's floating-point parameter tensors, each once."""
        out, seen = [], set()
        for name in self._getparamnames(""):
            val = _resolve(self, name)
            vals = val if isinstance(val, (tuple, list)) else (val,)
            for t in vals:
                if (torch.is_tensor(t) and (t.is_floating_point() or t.is_complex())
                        and id(t) not in seen):
                    seen.add(id(t))
                    out.append(t)
        return tuple(out)

    @contextmanager
    def _replaced_params(self, new: Dict[int, torch.Tensor]):
        """Within the block, each parameter tensor ``t`` with ``id(t)`` in
        ``new`` is replaced by ``new[id(t)]``; the originals come back after.

        The implicit-gradient rule differentiates the operator with respect
        to stand-ins of its parameters, so the derivative holds the
        solution fixed (the stand-ins are not on the solution's graph)."""
        saved = []
        for name in self._getparamnames(""):
            cur = _resolve(self, name)
            if isinstance(cur, (tuple, list)):
                rep = type(cur)(new.get(id(t), t) if torch.is_tensor(t) else t
                                for t in cur)
            elif torch.is_tensor(cur) and id(cur) in new:
                rep = new[id(cur)]
            else:
                continue
            saved.append((name, cur))
            _assign(self, name, rep)
        try:
            yield
        finally:
            for name, cur in reversed(saved):
                _assign(self, name, cur)

    # ------------------------- internal helpers -------------------------
    def _bcast_mv(self, x: torch.Tensor) -> torch.Tensor:
        # broadcast x's batch dims against the operator's declared batch
        # dims before dispatching to the subclass _mv, so _mv always sees
        # the fully-broadcast batch shape
        bout = get_bcasted_dims(x.shape[:-1], self.shape[:-2])
        return self._mv(x.expand(*bout, x.shape[-1]))

    def _adjoint_rmv(self, v: torch.Tensor) -> torch.Tensor:
        # v: (*Bv, p) -> (*Bout, q), computing A^H v exactly: the
        # vector-Jacobian product of a linear map is its adjoint (PyTorch's
        # convention conjugates for complex dtypes)
        bout = get_bcasted_dims(v.shape[:-1], self.shape[:-2])
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            x0 = torch.zeros((*bout, self.shape[-1]), dtype=v.dtype,
                             device=v.device, requires_grad=True)
            y = self._bcast_mv(x0)
            (g,) = torch.autograd.grad(y, x0, v.expand(y.shape),
                                       create_graph=create, allow_unused=True)
        return torch.zeros_like(x0.detach()) if g is None else g

    def __repr__(self) -> str:
        return "LinearOperator (%s) with shape %s, dtype = %s, device = %s" % (
            type(self).__name__, self.shape, self.dtype, self.device)

    # ------------------------- debug check -------------------------
    def check(self, warn: bool = True) -> None:
        """Run expensive shape/linearity checks (debug mode)."""
        checklinop(self)
        if warn:
            warnings.warn("... LinearOperator.check is performed, which is an "
                          "expensive operation. Make sure to turn off debug "
                          "mode in production.")


class AdjointLinearOperator(LinearOperator):
    """A^H of another operator."""

    def __init__(self, obj: LinearOperator):
        super().__init__(
            shape=obj.shape[:-2] + (obj.shape[-1], obj.shape[-2]),
            is_hermitian=obj.is_hermitian,
            dtype=obj.dtype,
            device=obj.device)
        self.obj = obj

    def _getparamnames(self, prefix: str = "") -> List[str]:
        return self.obj._getparamnames(prefix + "obj.")

    def _mv(self, x):
        return self.obj.rmv(x)

    def _mm(self, x):
        return self.obj.rmm(x)

    def _rmv(self, x):
        return self.obj.mv(x)

    def _rmm(self, x):
        return self.obj.mm(x)

    @property
    def H(self):
        return self.obj


class MatmulLinearOperator(LinearOperator):
    """Composition a @ b."""

    def __init__(self, a: LinearOperator, b: LinearOperator, is_hermitian: bool = False):
        shape = (*get_bcasted_dims(a.shape[:-2], b.shape[:-2]), a.shape[-2], b.shape[-1])
        super().__init__(
            shape=shape,
            is_hermitian=is_hermitian,
            dtype=a.dtype,
            device=a.device)
        self.a = a
        self.b = b

    def _getparamnames(self, prefix: str = "") -> List[str]:
        return self.a._getparamnames(prefix + "a.") + self.b._getparamnames(prefix + "b.")

    def _mv(self, x):
        return self.a.mv(self.b.mv(x))

    def _mm(self, x):
        return self.a.mm(self.b.mm(x))

    def _rmv(self, x):
        return self.b.rmv(self.a.rmv(x))

    def _rmm(self, x):
        return self.b.rmm(self.a.rmm(x))


class AddLinearOperator(LinearOperator):
    """a + mul*b."""

    def __init__(self, a: LinearOperator, b: LinearOperator, mul: int = 1):
        shape = (*get_bcasted_dims(a.shape[:-2], b.shape[:-2]), *a.shape[-2:])
        super().__init__(
            shape=shape,
            is_hermitian=a.is_hermitian and b.is_hermitian,
            dtype=a.dtype,
            device=a.device)
        if mul not in (1, -1):
            raise ValueError("mul must be 1 or -1 (got %r)" % (mul,))
        self.a = a
        self.b = b
        self.mul = mul

    def _getparamnames(self, prefix: str = "") -> List[str]:
        return self.a._getparamnames(prefix + "a.") + self.b._getparamnames(prefix + "b.")

    def _mv(self, x):
        return self.a.mv(x) + self.mul * self.b.mv(x)

    def _mm(self, x):
        return self.a.mm(x) + self.mul * self.b.mm(x)

    def _rmv(self, x):
        return self.a.rmv(x) + self.mul * self.b.rmv(x)

    def _rmm(self, x):
        return self.a.rmm(x) + self.mul * self.b.rmm(x)


class MulLinearOperator(LinearOperator):
    """a * scalar."""

    def __init__(self, a: LinearOperator, f: Union[int, float]):
        super().__init__(
            shape=a.shape,
            is_hermitian=a.is_hermitian,
            dtype=a.dtype,
            device=a.device)
        self.a = a
        self.f = f

    def _getparamnames(self, prefix: str = "") -> List[str]:
        return self.a._getparamnames(prefix + "a.")

    def _mv(self, x):
        return self.a.mv(x) * self.f

    def _mm(self, x):
        return self.a.mm(x) * self.f

    def _rmv(self, x):
        return self.a.rmv(x) * self.f

    def _rmm(self, x):
        return self.a.rmm(x) * self.f


class MatrixLinearOperator(LinearOperator):
    """Explicit (batched) matrix as an operator.

    Products run in IEEE float32 for float32 matrices (never TF32), the
    counterpart of the JAX package's HIGHEST-precision default.
    """

    def __init__(self, mat: torch.Tensor, is_hermitian: bool):
        super().__init__(
            shape=tuple(mat.shape),
            is_hermitian=is_hermitian,
            dtype=mat.dtype,
            device=mat.device)
        self.mat = mat

    def _getparamnames(self, prefix: str = "") -> List[str]:
        return [prefix + "mat"]

    def _mv(self, x):
        return einsum_hi("...pq,...q->...p", self.mat, x)

    def _mm(self, x):
        return dot_hi(self.mat, x)

    def _rmv(self, x):
        return einsum_hi("...pq,...p->...q", self.mat.conj(), x)

    def _rmm(self, x):
        return dot_hi(self.mat.mH, x)

    def _fullmatrix(self):
        return self.mat


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def checklinop(linop: LinearOperator) -> None:
    """Verify a LinearOperator's shape handling, linearity and batch
    consistency across an input-shape grid."""
    shape = linop.shape
    p, q = shape[-2:]
    batchshape = shape[:-2]

    def runtest(methodname, xshape, yshape, base_rank):
        x = torch.as_tensor(np.random.default_rng(42).standard_normal(xshape),
                            dtype=linop.dtype, device=linop.device)
        fcn = getattr(linop, methodname)
        try:
            y = fcn(x)
        except Exception as e:
            raise AssertionError(
                "checklinop: .%s failed on input shape %s (operator shape %s). "
                "The _mv/_mm implementation is likely not batch-safe — use "
                "broadcasting ops (einsum '...pq,...q->...p') instead of plain "
                "matmul. Original error: %s" % (methodname, xshape, shape, e)) from e
        if tuple(y.shape) != tuple(yshape):
            raise AssertionError(
                "The shape of .%s output is %s, expected %s"
                % (methodname, tuple(y.shape), tuple(yshape)))
        y2 = fcn(2.1 * x)
        if not np.allclose(_np(y2), _np(2.1 * y), atol=1e-5):
            raise AssertionError("The method .%s is not linear" % methodname)
        # batch consistency: apply on one batch element of the extra dim
        if len(xshape) > base_rank + len(batchshape):
            y0 = fcn(x[0])
            if not np.allclose(_np(y[0]), _np(y0), atol=1e-5):
                raise AssertionError(
                    "The method .%s does not behave consistently on batched input"
                    % methodname)

    checks = [
        ("mv", (q,), (*batchshape, p), 1),
        ("rmv", (p,), (*batchshape, q), 1),
        ("mm", (q, 3), (*batchshape, p, 3), 2),
        ("rmm", (p, 3), (*batchshape, q, 3), 2),
    ]
    extra_batch = (2,)
    for methodname, xshape, yshape, base_rank in checks:
        runtest(methodname, xshape, yshape, base_rank)
        bx = (*extra_batch, *batchshape, *xshape)
        by = (*extra_batch, *yshape)
        runtest(methodname, bx, by, base_rank)

    # fullmatrix consistency with mv
    full = _np(linop.fullmatrix())
    x = np.random.default_rng(0).standard_normal((q,))
    y_mv = _np(linop.mv(torch.as_tensor(x, dtype=linop.dtype, device=linop.device)))
    y_full = full @ x
    if not np.allclose(y_mv, y_full, atol=1e-5):
        raise AssertionError(".fullmatrix() is inconsistent with .mv()")
