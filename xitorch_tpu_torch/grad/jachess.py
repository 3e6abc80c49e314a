"""Jacobian and Hessian as matrix-free LinearOperators (counterpart of
xitorch_tpu/grad/jachess.py).

The operator is flattened: shape ``(nout, nin)`` over the raveled output
and input, with any batch dims on the vectors given to ``mv``/``rmv``.

* ``rmv`` (``J^H w``) is one vector-Jacobian product, ``torch.autograd.grad``
  of the function's output with cotangent ``w``.
* ``mv`` (``J v``) is the double-VJP trick: ``u -> J^H u`` is linear in
  ``u``, so its own vector-Jacobian product with cotangent ``v`` is
  ``J v``.  Chosen over ``torch.func.jvp`` (forward mode) because it needs
  nothing but backward formulas: the callables given to this package call
  its own ``autograd.Function``s (``solve``, ``symeig``), which define a
  backward and no forward-mode rule.

Both build their graphs when gradients are enabled at the call, so the
products are differentiable again, to the operator's parameters, to the
point ``x`` and to whatever the callable captures: second-order
derivatives through an implicit rule that solves with this operator work.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Union

import torch

from xitorch_tpu_torch._core.linop import LinearOperator

__all__ = ["jac", "hess"]


def jac(fcn: Callable, params: Sequence[Any],
        idxs: Union[None, int, Sequence[int]] = None,
        is_hermitian: bool = False) -> Union[LinearOperator, List[LinearOperator]]:
    """LinearOperator(s) acting as the Jacobian of ``fcn`` with respect to
    ``params[idx]``, evaluated at ``params``.

    ``idxs=None`` selects every floating-point tensor of ``params``; an int
    returns the operator itself, a sequence a list.  ``is_hermitian=True``
    declares the Jacobian symmetric (``fcn`` is itself a gradient, so J is a
    Hessian), which opens the hermitian-only solvers (cg, cg_ir) on it."""
    res = [_Jac(fcn, params, idx, is_hermitian=is_hermitian)
           for idx in _setup_idxs(idxs, params)]
    return res[0] if isinstance(idxs, int) else res


def hess(fcn: Callable, params: Sequence[Any],
         idxs: Union[None, int, Sequence[int]] = None
         ) -> Union[LinearOperator, List[LinearOperator]]:
    """LinearOperator(s) acting as the Hessian of the scalar-output ``fcn``
    (summed if it is not a scalar; the real part for complex output) with
    respect to ``params[idx]``: the Jacobian of the gradient, hermitian."""

    def gen_grad_fcn(idx):
        def grad_fcn(*ps):
            with torch.enable_grad():
                x = ps[idx]
                out = fcn(*ps)
                out = out.real.sum() if out.is_complex() else out.sum()
                (g,) = torch.autograd.grad(out, x, create_graph=True, allow_unused=True)
            return torch.zeros_like(x) if g is None else g
        return grad_fcn

    res = [_Jac(gen_grad_fcn(idx), params, idx, is_hermitian=True,
                out_like=params[idx])
           for idx in _setup_idxs(idxs, params)]
    return res[0] if isinstance(idxs, int) else res


class _Jac(LinearOperator):
    def __init__(self, fcn: Callable, params: Sequence[Any], idx: int,
                 is_hermitian: bool = False, out_like=None):
        x = params[idx]
        if out_like is None:
            # one evaluation for the output's shape and type
            with torch.enable_grad():
                out_like = fcn(*params)
        nin = int(math.prod(x.shape))
        nout = int(math.prod(out_like.shape))
        super().__init__(shape=(nout, nin), is_hermitian=is_hermitian,
                         dtype=out_like.dtype, device=x.device)
        self.fcn = fcn
        self.params = tuple(params)
        self.idx = idx
        self.inshape = tuple(x.shape)
        self.outshape = tuple(out_like.shape)
        self.nin = nin
        self.nout = nout

    def _getparamnames(self, prefix: str = "") -> List[str]:
        return [prefix + "params[%d]" % i for i, p in enumerate(self.params)
                if torch.is_tensor(p) and (p.is_floating_point() or p.is_complex())]

    def _evaluated(self):
        """(x, f(x)) with x on the graph: the point itself when it carries
        a graph (so that products are differentiable in it), else a fresh
        leaf of its value."""
        x = self.params[self.idx]
        xv = x.view_as(x) if x.requires_grad else x.detach().requires_grad_()
        ps = list(self.params)
        ps[self.idx] = xv
        return xv, self.fcn(*ps)

    def _mv(self, v: torch.Tensor) -> torch.Tensor:
        # v: (..., nin) -> (..., nout): J v by the double-VJP trick
        batch = v.shape[:-1]
        vs = v.reshape(-1, self.nin)
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            xv, y = self._evaluated()
            u = torch.zeros(self.outshape, dtype=y.dtype, device=y.device,
                            requires_grad=True)
            (jtu,) = torch.autograd.grad(y, xv, u, create_graph=True, allow_unused=True)
            if jtu is None or not jtu.requires_grad:
                return torch.zeros((*batch, self.nout), dtype=self.dtype, device=v.device)
            out = []
            for k in range(vs.shape[0]):
                (jv,) = torch.autograd.grad(
                    jtu, u, vs[k].reshape(self.inshape).to(jtu.dtype),
                    create_graph=create, retain_graph=True, allow_unused=True)
                out.append(torch.zeros(self.nout, dtype=self.dtype, device=v.device)
                           if jv is None else jv.reshape(-1))
        return torch.stack(out).reshape(*batch, self.nout)

    def _rmv(self, w: torch.Tensor) -> torch.Tensor:
        # w: (..., nout) -> (..., nin): J^H w (PyTorch's vector-Jacobian
        # product conjugates for complex types)
        batch = w.shape[:-1]
        ws = w.reshape(-1, self.nout)
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            xv, y = self._evaluated()
            out = []
            for k in range(ws.shape[0]):
                (g,) = torch.autograd.grad(y, xv, ws[k].reshape(self.outshape).to(y.dtype),
                                           create_graph=create, retain_graph=True,
                                           allow_unused=True)
                out.append(torch.zeros(self.nin, dtype=xv.dtype, device=w.device)
                           if g is None else g.reshape(-1))
        return torch.stack(out).reshape(*batch, self.nin)

    def _mm(self, x: torch.Tensor) -> torch.Tensor:
        # columns into the batch of mv: one evaluation of the function
        return self._mv(x.mT).mT

    def _rmm(self, x: torch.Tensor) -> torch.Tensor:
        return self._rmv(x.mT).mT


def _setup_idxs(idxs, params) -> List[int]:
    if idxs is None:
        return [i for i, p in enumerate(params)
                if torch.is_tensor(p) and (p.is_floating_point() or p.is_complex())]
    if isinstance(idxs, int):
        return [idxs]
    return list(idxs)
