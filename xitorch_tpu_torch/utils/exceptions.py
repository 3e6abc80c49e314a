"""Warning and error taxonomy (counterpart of xitorch_tpu/utils/exceptions.py).

Solvers return structured info dicts; the warning classes here are raised
from the eager wrappers and from input validation.
"""

__all__ = ["GetSetParamsError", "ConvergenceWarning", "MathWarning"]


class GetSetParamsError(Exception):
    """Raised when parameter declaration/extraction on an operator is invalid."""


class ConvergenceWarning(Warning):
    """Warning issued when an iterative algorithm does not converge.

    Solvers never raise on non-convergence: they return the best iterate
    seen and flag it in their info dict.
    """


class MathWarning(Warning):
    """Warning raised when mathematical conditions (e.g. degeneracy
    requirements in symeig derivatives) are not satisfied."""
