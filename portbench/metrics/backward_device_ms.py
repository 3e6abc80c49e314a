"""Public API layer: self device time a call of the solve's autograd
backward (``xt.solve.backward`` less its nested ``xt.solve``, the adjoint
solve): the gradient contractions, from the program's spans in a profiler
trace, in ms."""
from portbench import spans


def read(obs):
    sp = spans.of(obs)
    return None if sp is None else sp.device_ms({"xt.solve.backward"}, self_only=True)
