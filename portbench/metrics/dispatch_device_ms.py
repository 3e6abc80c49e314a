"""Dispatchers and library calls: device time a call inside the solve and
eigen methods (``xt.solve.method``, ``xt.symeig.method``) outside the
port's own kernels (every kernel with a count file in
``portbench/rooflines/``): layout copies, shifts, extraction, polish, from
the program's spans in a profiler trace, in ms."""
from portbench import spans
from portbench.harness import port_kernel_parts


def read(obs):
    sp = spans.of(obs)
    if sp is None:
        return None
    return sp.device_ms({"xt.solve.method", "xt.symeig.method"}, skip=port_kernel_parts())
