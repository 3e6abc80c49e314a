"""Failure detection over the ``(solution, info)`` convention (counterpart
of xitorch_tpu/utils/convergence.py).

PyTorch runs eagerly, so only the eager branch of the JAX version exists:
a plain raise.
"""
from __future__ import annotations

import torch

__all__ = ["assert_converged"]


def assert_converged(info, what: str = "solve") -> None:
    """Raise :class:`RuntimeError` if an info dict reports non-convergence.

    ``info`` is the dict returned by any functional with
    ``return_info=True`` (keys ``converged``/``iterations``/``resid``/
    ``resid_rel``).
    """
    conv = torch.as_tensor(info["converged"])
    if float(conv.min()) < 1.0:
        raise RuntimeError(
            "%s did not converge after %d iterations (final residual "
            "%.3e, %.1fx the tolerance)"
            % (what, int(torch.as_tensor(info["iterations"]).max()),
               float(torch.as_tensor(info["resid"]).max()),
               float(torch.as_tensor(info["resid_rel"]).max())))
