"""Dispatchers and library calls: every device launch (kernels, copies,
sets) a call, from the profiler's trace."""


def read(obs):
    return None if obs.trace is None else obs.trace.launches() / obs.trace.calls
