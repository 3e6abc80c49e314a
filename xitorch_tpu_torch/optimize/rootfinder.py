"""rootfinder / equilibrium / minimize with implicit-function gradients
(counterpart of xitorch_tpu/optimize/rootfinder.py).

* Forward: the selected solver (broyden1/2, newton, linearmixing,
  anderson_acc, gd, adam, lbfgs) runs without gradients.
* Backward: for the root ``f(y*, theta) = 0`` the implicit rule gives
  ``dy = -J^{-1} (df/dtheta) dtheta`` with ``J = df/dy`` at ``y*``; its
  transpose solves ``J^H lam = -g`` for the output's cotangent ``g`` with
  the public :func:`~xitorch_tpu_torch.linalg.solve` on the matrix-free
  ``grad.jac`` operator's ``.H`` (with ``bck_options``), and pushes ``lam``
  through the autograd graph of ``f(y*, theta)``.
* Which tensors get gradients: every tensor the graph of
  ``fcn(y*.detach(), *params)`` reaches, the ``params`` and the tensors
  ``fcn`` captures in its closure alike.  The tensors ``fcn`` holds itself
  (closure cells, defaults) and the leaves that graph reaches beyond them
  (a module's parameters, say) become inputs of the autograd function, so
  that ``torch.autograd.grad`` can ask for any of them; a non-leaf that the
  callable reaches only indirectly passes its gradient on to its leaves.
* Every order: the backward evaluates ``f`` and ``J`` at the output ``y``
  itself (which carries this rule's graph), and the adjoint solve is
  differentiated through the operator's autograd graph, so the gradient is
  differentiable again (``create_graph=True``) to all of those tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence, Union

import torch

from xitorch_tpu_torch._impls.optimize.equilibrium import anderson_acc
from xitorch_tpu_torch._impls.optimize.minimizer import adam, gd, lbfgs
from xitorch_tpu_torch._impls.optimize.rootsolver import (
    broyden1, broyden2, linearmixing, newton,
)
from xitorch_tpu_torch.debug.modes import is_debug_enabled
from xitorch_tpu_torch.grad.jachess import jac
from xitorch_tpu_torch.linalg.solve import solve
from xitorch_tpu_torch.utils.assertfuncs import assert_fcn_params
from xitorch_tpu_torch.utils.misc import get_method

__all__ = ["rootfinder", "equilibrium", "minimize"]

_RF_METHODS = {
    "newton": newton,
    "broyden1": broyden1,
    "broyden2": broyden2,
    "linearmixing": linearmixing,
}

_EQUIL_METHODS = {
    "anderson_acc": anderson_acc,
}

_OPT_METHODS = {
    "gd": gd,
    "adam": adam,
    "lbfgs": lbfgs,
}


# ------------------------------------------------------------------
# linear solves differentiated through the operator's autograd graph
# ------------------------------------------------------------------

def _solve_vec(op, b: torch.Tensor, bck: Mapping[str, Any]) -> torch.Tensor:
    """``op x = b`` for a flat vector b, by the public solve, no graph."""
    with torch.no_grad():
        x = solve(op, b.detach().reshape(-1, 1), bck_options=bck, **bck)
    return x.reshape(b.shape)


def _implicit_solve(op, b: torch.Tensor, bck: Mapping[str, Any]) -> torch.Tensor:
    """``x = op^{-1} b``, differentiable in ``b`` and in everything ``op``'s
    products depend on through autograd (its point, its parameters, what
    its function captures): with ``r = op x`` recomputed on the graph at
    the solution, ``dx = op^{-1} (db - dr)``, whose transpose is
    ``mu = op^{-H} gx`` into ``b`` and ``-mu`` into ``r``."""
    x = _solve_vec(op, b, bck)
    if not torch.is_grad_enabled():
        return x
    r = op.mv(x.reshape(-1)).reshape(b.shape)
    if not (r.requires_grad or b.requires_grad):
        return x
    return _LinearSolve.apply(r, b, x, op, bck)


class _LinearSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, b, x, op, bck):
        ctx.op, ctx.bck = op, bck
        return x.clone()

    @staticmethod
    def backward(ctx, gx):
        mu = _implicit_solve(ctx.op.H, gx, ctx.bck)
        return -mu, mu, None, None, None


# ------------------------------------------------------------------
# the implicit rule
# ------------------------------------------------------------------

def _captured_tensors(fcn) -> list:
    """The tensors requiring grad that ``fcn`` holds itself: in its closure
    cells, its defaults, a bound method's object or a partial's arguments
    (one level into tuples, lists and dicts).  They become inputs as they
    are, so that a captured view or other non-leaf can be asked for its
    gradient too."""
    found = []

    def add(obj):
        if torch.is_tensor(obj):
            if obj.requires_grad:
                found.append(obj)
        elif isinstance(obj, (tuple, list)):
            for o in obj:
                if torch.is_tensor(o) and o.requires_grad:
                    found.append(o)
        elif isinstance(obj, dict):
            add(list(obj.values()))

    for cell in getattr(fcn, "__closure__", None) or ():
        try:
            add(cell.cell_contents)
        except ValueError:   # an empty cell
            pass
    add(getattr(fcn, "__defaults__", None) or ())
    add(list(getattr(fcn, "keywords", {}).values()) + list(getattr(fcn, "args", ())))
    self_obj = getattr(fcn, "__self__", None)
    if self_obj is not None:
        add(list(vars(self_obj).values()) if hasattr(self_obj, "__dict__") else [])
    return found


def _graph_leaves(out: torch.Tensor, params, y: torch.Tensor) -> list:
    """The leaf tensors requiring grad that ``out``'s graph reaches other
    than through ``params`` and the point ``y`` (a leaf): the tensors the
    callable captures."""
    stop_nodes = {id(p.grad_fn) for p in params if p.grad_fn is not None}
    stop_vars = {id(p) for p in params} | {id(y)}
    leaves, seen, stack = [], set(), [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen or id(node) in stop_nodes:
            continue
        seen.add(id(node))
        var = getattr(node, "variable", None)
        if var is not None:
            if id(var) not in stop_vars:
                leaves.append(var)
            continue
        stack.extend(nxt for nxt, _ in node.next_functions)
    return leaves


class _ImplicitRoot(torch.autograd.Function):
    """Inputs ``(spec, ystar, *inputs)``: ``inputs`` are the tensors that
    get gradients (the tensor params, then the captured leaves); ``spec``
    holds the residual ``res(y, *params)``, the params and the backward's
    options."""

    @staticmethod
    def forward(ctx, spec, ystar, *inputs):
        ctx.spec = spec
        y = ystar.clone()
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        spec = ctx.spec
        inputs = spec["inputs"]
        if spec["partial"]:
            # reached from the partial derivative below through the point
            # y: that path is not part of it
            return (None, None) + (None,) * len(inputs)
        (y,) = ctx.saved_tensors
        create = torch.is_grad_enabled()   # True only when differentiating again
        res_y = spec["res_y"]
        jop = jac(res_y, (y,), idxs=0, is_hermitian=spec["hermitian"])
        # J^H lam = -g, differentiable in g, y and the callable's tensors
        lam = _implicit_solve(jop.H, -g, spec["bck"])
        with torch.enable_grad():
            # the partial derivative (df/dtheta)^H lam at the point y; when
            # differentiating again, y stays on the graph (the saved tensors
            # of f's backward carry it), so the next order sees y(theta)
            f = res_y(y.view_as(y) if create else y.detach())
            spec["partial"] = True
            try:
                grads = torch.autograd.grad(f, inputs, lam.to(f.dtype), create_graph=create,
                                            retain_graph=True, allow_unused=True)
            finally:
                spec["partial"] = False
        return (None, None) + tuple(torch.zeros_like(t) if gr is None else gr
                                    for t, gr in zip(inputs, grads))


def _implicit_rootsolve(res_fcn: Callable, run_solver: Callable, y0, params,
                        bck_options: Mapping[str, Any], has_info: bool = False,
                        hermitian: bool = False, fcn: Callable = None):
    """Run ``run_solver(y0)`` without gradients and attach the implicit rule
    of ``res_fcn(y*, *params) = 0`` to its root; ``fcn`` is the user's
    callable, whose captured tensors get gradients.  With ``has_info`` the
    solver returns ``(y, info)`` and info carries no gradient.
    ``hermitian`` declares the residual's Jacobian symmetric (minimize: it
    is a Hessian), so the backward may use hermitian-only methods."""
    with torch.no_grad():
        out = run_solver(y0)
    ystar, info = out if has_info else (out, None)
    ystar = ystar.detach()

    tparams = [p for p in params if torch.is_tensor(p) and p.requires_grad]
    tparams = list({id(p): p for p in tparams + _captured_tensors(fcn)}.values())
    inputs = []
    if torch.is_grad_enabled():
        # one evaluation at the root, on the graph: which tensors it reaches
        yl = ystar.clone().requires_grad_()
        with torch.enable_grad():
            f = res_fcn(yl, *params)
        if f.requires_grad:
            inputs = tparams + _graph_leaves(f, tparams, yl)
    if inputs:
        spec = {"res_y": lambda y: res_fcn(y, *params), "inputs": inputs,
                "hermitian": hermitian, "bck": dict(bck_options), "partial": False}
        ystar = _ImplicitRoot.apply(spec, ystar, *inputs)
    return (ystar, info) if has_info else ystar


def rootfinder(fcn: Callable, y0: torch.Tensor,
               params: Sequence[Any] = (),
               bck_options: Mapping[str, Any] = {},
               method: Union[str, Callable, None] = None,
               **fwd_options) -> torch.Tensor:
    r"""Solve :math:`\mathbf{0} = \mathbf{f}(\mathbf{y}, \theta)`.

    ``fcn(y, *params) -> (*ny)``; returns ``y`` of shape ``(*ny)`` with
    implicit first- and higher-order gradients to the tensors in ``params``
    and to those ``fcn`` captures.  Methods: "broyden1" (default),
    "broyden2", "newton", "linearmixing", or a custom callable
    ``(fcn, y0, params, **fwd_options) -> y``.  ``bck_options`` configure
    the adjoint solve of the backward (``"method"`` plus that method's
    options).  With ``return_info=True`` returns ``(y, info)``.

    Examples
    --------
    >>> import torch
    >>> from xitorch_tpu_torch.optimize import rootfinder
    >>> y = rootfinder(lambda y, a: y ** 3 + 2 * y - a, torch.tensor([0.0]),
    ...                params=(torch.tensor([3.0]),))
    >>> bool((y[0] - 1.0).abs() < 1e-6)
    True
    """
    if method is None:
        method = "broyden1"
    if is_debug_enabled():
        assert_fcn_params(fcn, (y0, *params), what="rootfinder fcn", expect_like=y0)
    method_fcn = get_method("rootfinder", _RF_METHODS, method)

    def run_solver(y0_):
        return method_fcn(fcn, y0_, params, **fwd_options)

    return _implicit_rootsolve(fcn, run_solver, y0, params, bck_options,
                               has_info=bool(fwd_options.get("return_info")), fcn=fcn)


def equilibrium(fcn: Callable, y0: torch.Tensor,
                params: Sequence[Any] = (),
                bck_options: Mapping[str, Any] = {},
                method: Union[str, Callable, None] = None,
                **fwd_options) -> torch.Tensor:
    r"""Solve the fixed point :math:`\mathbf{y} = \mathbf{f}(\mathbf{y},\theta)`.

    The root of ``g(y) = y - f(y)``; "anderson_acc" (and custom equilibrium
    methods) iterate on ``f`` directly.

    Examples
    --------
    >>> import torch
    >>> from xitorch_tpu_torch.optimize import equilibrium
    >>> y = equilibrium(lambda y: 0.5 * (y + 2.0 / y), torch.tensor([1.0]))
    >>> bool((y[0] - 2.0 ** 0.5).abs() < 1e-6)
    True
    """
    if method is None:
        method = "broyden1"
    if is_debug_enabled():
        assert_fcn_params(fcn, (y0, *params), what="equilibrium fcn", expect_like=y0)

    def res_fcn(y, *ps):
        return y - fcn(y, *ps)

    in_equil = isinstance(method, str) and method.lower() in _EQUIL_METHODS
    if in_equil:
        method_fcn = get_method("equilibrium", _EQUIL_METHODS, method)
        fwd_fcn = fcn
    else:
        method_fcn = get_method("rootfinder", _RF_METHODS, method)
        fwd_fcn = res_fcn

    def run_solver(y0_):
        return method_fcn(fwd_fcn, y0_, params, **fwd_options)

    return _implicit_rootsolve(res_fcn, run_solver, y0, params, bck_options,
                               has_info=bool(fwd_options.get("return_info")), fcn=fcn)


def minimize(fcn: Callable, y0: torch.Tensor,
             params: Sequence[Any] = (),
             bck_options: Mapping[str, Any] = {},
             method: Union[str, Callable, None] = None,
             **fwd_options) -> torch.Tensor:
    r"""Solve :math:`\mathbf{y^*} = \arg\min_y f(\mathbf{y},\theta)`
    (unbounded).

    Rootfinder methods run on ``grad_y f``; the optimizer methods ("gd",
    "adam", "lbfgs") receive ``(f, grad_y f)`` pairs.  The implicit
    gradients come from the stationarity condition ``grad_y f = 0``, whose
    Jacobian (the Hessian) is declared hermitian for the backward solve.

    Examples
    --------
    >>> import torch
    >>> from xitorch_tpu_torch.optimize import minimize
    >>> a = torch.tensor([1.0, -2.0])
    >>> y = minimize(lambda y, a: ((y - a) ** 2).sum(), torch.zeros(2), params=(a,))
    >>> bool((y - a).abs().max() < 1e-6)
    True
    """
    if y0.is_complex():
        raise AssertionError("complex y0 is not supported in minimize")
    if method is None:
        method = "broyden1"
    if is_debug_enabled():
        assert_fcn_params(fcn, (y0, *params), what="minimize fcn")

    def scalar_fcn(y, *ps):
        out = fcn(y, *ps)
        if out.numel() != 1:
            # a vector objective must not be summed silently
            raise RuntimeError("minimize fcn must return a scalar (got shape %s)"
                               % (tuple(out.shape),))
        return out.sum()

    def value_grad_fcn(y, *ps):
        # on the graph when called with gradients enabled (the implicit
        # rule differentiates the gradient again: the Hessian), without
        # inside the solvers' loops
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            yv = y.view_as(y) if y.requires_grad else y.detach().requires_grad_()
            f = scalar_fcn(yv, *ps)
            (g,) = torch.autograd.grad(f, yv, create_graph=create, allow_unused=True)
        return f, torch.zeros_like(y) if g is None else g

    def grad_fcn(y, *ps):
        return value_grad_fcn(y, *ps)[1]

    is_opt = isinstance(method, str) and method.lower() in _OPT_METHODS
    if is_opt:
        method_fcn = get_method("minimizer", _OPT_METHODS, method)
        fwd_fcn = value_grad_fcn
    else:
        method_fcn = get_method("rootfinder", _RF_METHODS, method)
        fwd_fcn = grad_fcn

    def run_solver(y0_):
        return method_fcn(fwd_fcn, y0_, params, **fwd_options)

    return _implicit_rootsolve(grad_fcn, run_solver, y0, params, bck_options,
                               has_info=bool(fwd_options.get("return_info")),
                               hermitian=True, fcn=fcn)


# docstring completion: each method's options
from xitorch_tpu_torch._docstr.api_docstr import get_methods_docstr  # noqa: E402

rootfinder.__doc__ = get_methods_docstr(rootfinder, _RF_METHODS)
equilibrium.__doc__ = get_methods_docstr(equilibrium, {**_RF_METHODS, **_EQUIL_METHODS})
minimize.__doc__ = get_methods_docstr(minimize, {**_RF_METHODS, **_OPT_METHODS})
