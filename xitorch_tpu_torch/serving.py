"""Ahead-of-time export for serving (counterpart of xitorch_tpu/serving.py).

``export_bytes`` traces ``fn`` once on example arguments with
``torch.export`` into a shape-specialised forward program and serialises
it; ``import_bytes`` loads it back into a callable that runs without
tracing ``fn`` again, in this process or in another one that imports this
package (importing ``xitorch_tpu_torch`` registers the kernels' operators
the program calls).  The kernels are ``torch.library`` operators, so a
program holds their launches as calls, on the device of its inputs.

Example
-------
>>> import xitorch_tpu_torch.serving as serving
>>> fn = lambda mat, b: xitorch_tpu_torch.linalg.solve(
...     xitorch_tpu_torch.LinearOperator.m(mat, is_hermitian=True), b,
...     method="exactsolve")
>>> blob = serving.export_bytes(fn, (mat, b))      # bytes, persist anywhere
>>> served = serving.import_bytes(blob)            # in the serving process
>>> x = served(mat, b)

A method that reads its stop flag on the host every step (``cg``,
``cg_ir``, ``minres``, ``bicgstab``, ``gmres``, ``broyden1``, ``davidson``,
``chebfsi``, the ``optimize`` loops, the ``integrate`` steppers) has no
fixed program: tracing it raises a ``RuntimeError`` that says so.  The
program is forward only (traced under ``torch.no_grad()``).
"""
from __future__ import annotations

import io
import os
from typing import Callable, Sequence

import torch
from torch.utils import _pytree

from xitorch_tpu_torch.models.deq import DEQParams
from xitorch_tpu_torch.models.node import NODEParams

__all__ = ["export_bytes", "import_bytes", "aot_compile"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Fn(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _register_namedtuple(cls) -> None:
    """Give a NamedTuple type a serialised name, so that a program whose
    inputs or outputs hold one can be saved and loaded."""
    if cls not in _pytree.SUPPORTED_SERIALIZED_TYPES:
        _pytree._register_namedtuple(
            cls, serialized_type_name="%s.%s" % (cls.__module__, cls.__qualname__))


def _register_namedtuples(spec) -> None:
    if _pytree.is_namedtuple_class(spec.type):
        _register_namedtuple(spec.type)
    # children_specs was deprecated for children() (absent from older torch)
    children = spec.children() if hasattr(spec, "children") else spec.children_specs
    for child in children:
        _register_namedtuples(child)


# the package's own NamedTuples that cross its surface, known to every
# process that imports this module
for _cls in (DEQParams, NODEParams):
    _register_namedtuple(_cls)


def _host_loop(err: BaseException):
    """The outermost method of the package (``_impls/``) on the traceback of
    a tracer's error, ``"name (file)"``, or None: the methods there that
    fail to trace are the loops that read a value on the host (the direct
    ones trace)."""
    tb = err.__traceback__
    while tb is not None:
        code = tb.tb_frame.f_code
        if os.path.join("xitorch_tpu_torch", "_impls", "") in code.co_filename:
            return "%s (%s)" % (code.co_name, os.path.relpath(code.co_filename, _ROOT))
        tb = tb.tb_next
    return None


def _export(fn: Callable, example_args: Sequence) -> torch.export.ExportedProgram:
    try:
        with torch.no_grad():
            return torch.export.export(_Fn(fn), tuple(example_args))
    except Exception as err:  # the tracer's errors share no base class
        method = _host_loop(err)
        if method is None:
            raise
        # a data-dependent branch (the stop flag) or, first, a construct of
        # the loop's set-up that the tracer does not take (which one depends
        # on torch's version)
        raise RuntimeError(
            "serving: %s reads its stop flag on the host each step, which a traced "
            "program cannot hold, so it cannot be exported (nor can cg, cg_ir, minres, "
            "bicgstab, gmres, broyden1, davidson, chebfsi, the optimize loops or the "
            "integrate steppers); exactsolve, kron_direct and structured_cg can.  The "
            "tracer: %s" % (method, str(err).splitlines()[0] if str(err) else
                            type(err).__name__)) from err


def export_bytes(fn: Callable, example_args: Sequence) -> bytes:
    """Trace ``fn`` on ``example_args`` into a shape-specialised forward
    program and serialise it (``torch.export.save``).

    NamedTuple containers in the arguments or results are registered for
    serialisation; a process that loads a program holding a NamedTuple of
    its own must register that type the same way before
    :func:`import_bytes` (the package's own are registered by importing
    this module)."""
    ep = _export(fn, example_args)
    _register_namedtuples(ep.call_spec.in_spec)
    _register_namedtuples(ep.call_spec.out_spec)
    # the program, not its example data (at config 3 they would be 12 MB)
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def import_bytes(blob: bytes) -> Callable:
    """Deserialise an exported program into a callable."""
    return torch.export.load(io.BytesIO(blob)).module()


def aot_compile(fn: Callable, example_args: Sequence) -> Callable:
    """Trace ``fn`` on ``example_args`` into a shape-specialised forward
    program for the device of its arguments and return it as a callable;
    the exported program is its ``.exported`` attribute."""
    ep = _export(fn, example_args)
    mod = ep.module()
    mod.exported = ep
    return mod
