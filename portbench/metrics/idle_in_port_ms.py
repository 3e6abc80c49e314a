"""Public API layer: time a call in which the card is idle while some
thread of the host is inside one of the program's top-level ``xt.`` spans
(the device's idle intervals of the traced window intersected with the
union of those spans, less the profiler's own work there), from a
profiler trace, in ms."""
from portbench import spans


def read(obs):
    sp = spans.of(obs)
    return None if sp is None else 1e3 * sp.idle_s / sp.calls
