"""Dispatchers and library calls: device time a call outside the port's
own kernels (every kernel with a count file in ``portbench/rooflines/``),
by name from the profiler's trace, in ms."""
from portbench.harness import port_kernel_parts


def read(obs):
    tr = obs.trace
    if tr is None:
        return None
    parts = port_kernel_parts()
    other = sum(sec for name, (sec, _) in tr.by_name.items()
                if not any(p in name for p in parts))
    return 1e3 * other / tr.calls
