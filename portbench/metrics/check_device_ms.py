"""Public API layer: device time a call of the kernels launched inside the
eager convergence check (``xt.solve.check``, the forward's and the
adjoint's), from the program's spans in a profiler trace, in ms."""
from portbench import spans


def read(obs):
    sp = spans.of(obs)
    return None if sp is None else sp.device_ms({"xt.solve.check"})
