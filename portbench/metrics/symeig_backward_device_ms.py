"""Public API layer: device time a call under ``xt.symeig.backward``, the
backward of ``degen_eigh`` (the transposed tangent rule's products), from
the program's spans in a profiler trace, in ms; None where the program
has no such span."""
from portbench import spans


def read(obs):
    sp = spans.of(obs)
    return None if sp is None else sp.device_ms({"xt.symeig.backward"})
