"""Profiling helpers (counterpart of xitorch_tpu/debug/profiling.py, whose
``jax.profiler`` becomes ``torch.profiler``): a device timeline of a block,
written as a Chrome trace viewable in Perfetto or ``chrome://tracing``, and
named regions that show up inside it.

The port also marks its own phases, live only while a ``torch.profiler``
records (and never while ``torch.export`` or ``torch.compile`` traces a
program); with no profiler recording each costs one branch.

Spans (:func:`span`, profiler ranges on the host's timeline, so they share
the profiler's clock with the card's kernels; ``xt.solve.backward`` may run
on the autograd engine's thread, where nothing nests it under its forward):

* ``xt.solve``: ``linalg.solve``, whole;
* ``xt.solve.pending``: the queued convergence verdicts read at its entry;
* ``xt.solve.method``: the solve method (for structured_cg the dispatcher's
  layout and the kernel's operator);
* ``xt.solve.check``: the eager convergence check;
* ``xt.solve.backward``: the autograd backward (the adjoint solve, its own
  ``xt.solve``, and the gradient contractions);
* ``xt.symeig``: ``linalg.symeig``, whole;
* ``xt.symeig.method``: the eigen method (for exacteig the shift, the sweep
  kernel's operator, extraction, polish and sort);
* ``xt.symeig.backward``: the backward of ``degen_eigh`` (the transposed
  tangent rule), which may run on the autograd engine's thread.

Counts (:func:`count`, read by :func:`counts`): the per-system count tensor
each kernel call returns, kept by reference (no launch, no copy) for the
last ``COUNT_KEEP`` calls of each kernel, the oldest dropped:
``"structured_cg"`` (CG iterations a system), ``"jacobi_sweep"`` (sweeps
a matrix, the real sweep kernel) and ``"jacobi_sweep_complex"`` (sweeps a
matrix, the complex one).
"""
from __future__ import annotations

import collections
import contextlib
import os
from contextlib import contextmanager
from typing import List

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile as _torch_profile, record_function

__all__ = ["profile", "annotate", "span", "count", "counts", "tracing"]

# the calls whose counts are kept, a kernel: each entry holds its block of
# device memory past its call, so the first traced calls of a process may
# grow the allocator's pool (a cudaMalloc of 1-24 ms on the host at 262,144
# systems, the card idle); four hold a cycle of two inputs through a
# forward and its adjoint
COUNT_KEEP = 4
_OFF = contextlib.nullcontext()
_COUNTS: dict = {}


@contextmanager
def profile(logdir: str, **kwargs):
    """Capture a timeline trace of the enclosed block into ``logdir``
    (``trace.json``); the card's kernels too where a CUDA device exists.
    Extra keywords go to ``torch.profiler.profile``.

    >>> with xitorch_tpu_torch.debug.profile("xt-trace"):
    ...     x = solve(A, b)
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    kwargs.setdefault("activities", activities)
    with _torch_profile(**kwargs) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region that shows up inside profiler traces (and nests).

    >>> with xitorch_tpu_torch.debug.annotate("outer-scf-iteration"):
    ...     y = step(y)
    """
    return record_function(name)


def tracing() -> bool:
    """Whether a program is being traced (``torch.export``, ``torch.compile``):
    its values are not known, so the eager checks are skipped, as the JAX
    package skips them on tracers, and no span or count is kept."""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def _recording() -> bool:
    return torch._C._autograd._profiler_enabled() and not tracing()


def span(name: str):
    """The port's own span ``name`` (one of the ``xt.`` names above) while a
    profiler records, else one shared no-op context.  The range is entered
    from C++ (``_RecordFunctionFast``, as torch's compiled code marks its
    kernels), not through ``record_function``'s dispatched operators, which
    cost about ten times more host time a range; nor is it mirrored on the
    card's timeline."""
    if not _recording():
        return _OFF
    return _RecordFunctionFast(name)


def count(kernel: str, per_system: torch.Tensor) -> None:
    """Keep a reference to the per-system count a call of ``kernel``
    returned, while a profiler records."""
    if _recording():
        _COUNTS.setdefault(kernel, collections.deque(maxlen=COUNT_KEEP)).append(per_system)


def counts(kernel: str) -> List[torch.Tensor]:
    """The per-system counts kept for ``kernel``, oldest first (not cleared:
    each read sees every call still kept)."""
    return list(_COUNTS.get(kernel, ()))
