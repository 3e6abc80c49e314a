"""Profiling helpers (counterpart of xitorch_tpu/debug/profiling.py, whose
``jax.profiler`` becomes ``torch.profiler``): a device timeline of a block,
written as a Chrome trace viewable in Perfetto or ``chrome://tracing``, and
named regions that show up inside it."""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch
from torch.profiler import ProfilerActivity, profile as _torch_profile, record_function

__all__ = ["profile", "annotate"]


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
