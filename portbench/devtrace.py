"""Reading the card's trace from ``torch.profiler``.

``trace_calls`` profiles a number of calls and reduces the trace to a
:class:`Trace`: device time and launches by kernel name, the union of the
device's busy intervals over the traced window, and the idle gaps with
what the host was doing in each.  Only events on the card count as device
time.  Now and then a trace comes back with no event on the card, or
without the port's kernels (launched through ``ctypes``), or with only
some of their launches, while PyTorch's own still show: such a trace is
taken again, ``TRIES`` times in all (the rule of
``chip_smoke.py::device_ms_by_name``, copied).  If every trace lost them,
there is no trace, and every metric read from it is "not measured".
"""
import sys

TRIES = 3
# the longest idle gaps kept, each with what the host was doing
GAPS = 10
# record_function labels of the harness's own phases of a traced call
WINDOW, ISSUE, SYNC = "portbench.window", "portbench.issue", "portbench.sync"


class Trace:
    """One traced window of ``calls`` calls.

    ``by_name``: {kernel or copy name: (device seconds, launches)} over the
    window; ``busy_s``: the union of the device's busy intervals inside the
    window; ``window_s``: the window's length; ``gaps``: the idle gaps as
    ``(seconds, what the host was doing)``, longest first."""

    def __init__(self, calls, by_name, busy_s, window_s, gaps):
        self.calls, self.by_name = calls, by_name
        self.busy_s, self.window_s, self.gaps = busy_s, window_s, gaps

    def launches(self):
        return sum(count for _, count in self.by_name.values())

    def matching(self, part):
        """(device seconds, launches) of the kernels whose name holds ``part``."""
        hits = [v for k, v in self.by_name.items() if part in k]
        return sum(s for s, _ in hits), sum(c for _, c in hits)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label(cpu_events, t):
    """What the host was doing at time ``t``: the innermost host event that
    covers it (the latest to start), else "host idle"."""
    best = None
    for e in cpu_events:
        if e.time_range.start <= t <= e.time_range.end and e.name != WINDOW:
            if best is None or e.time_range.start > best.time_range.start:
                best = e
    return best.name if best is not None else "host idle"


def reduce(events, calls):
    """A :class:`Trace` from the profiler's events (``prof.events()``) of a
    window of ``calls`` calls marked by a ``WINDOW`` record_function."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name == WINDOW]
    if not marks:
        return None
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    # the harness's record_function labels also appear on the card's
    # timeline as annotations: not device work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and not e.name.startswith("portbench.")]
    by_name = {}
    for e in dev:
        sec, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (sec + (e.time_range.end - e.time_range.start) * 1e-6, count + 1)
    busy = _union([(max(lo, e.time_range.start), min(hi, e.time_range.end))
                   for e in dev if e.time_range.end > lo and e.time_range.start < hi])
    busy_us = sum(b - a for a, b in busy)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  reverse=True)[:GAPS]
    gaps = [(us * 1e-6, _label(cpu, a + 0.5 * us)) for us, a in gaps]
    return Trace(calls, by_name, busy_us * 1e-6, (hi - lo) * 1e-6, gaps)


def _lost(trace, expect):
    """Why a trace cannot be read (None if it can): no event on the card, an
    expected kernel missing, or not the same number of its launches in
    every call."""
    if trace is None or not trace.by_name:
        return "no event on the card"
    for part in expect:
        _, count = trace.matching(part)
        if count == 0:
            return "no event of %s" % part
        if count % trace.calls:
            return "not every call's launches of %s" % part
    return None


def trace_calls(torch, one_call, calls, expect):
    """Profile ``calls`` calls of ``one_call()`` (each ends in a synchronise)
    and return their :class:`Trace`, or None where every one of ``TRIES``
    traces lost the card's events or the kernels named in ``expect``."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for _ in range(calls):
                    one_call()
        trace = reduce(prof.events(), calls)
        why = _lost(trace, expect)
        if why is None:
            return trace
        print("profiler: trace %d of %d held %s; taking it again" % (attempt, TRIES, why),
              file=sys.stderr)
    print("profiler: no trace of %d held the card's events of %s: every device metric "
          "not measured" % (TRIES, list(expect)), file=sys.stderr)
    return None
