"""The port's own spans (``xt.``, ``xitorch_tpu_torch/debug/profiling.py``)
in a profiler trace: device time under each span, self time, and the
card's idle time while the host is inside one.

A kernel is under a span when the profiler links it (by correlation id,
the ``kernels`` of a host op) to an op that runs inside the span on the
same thread; the spans that hold it are its enclosing ``xt.`` spans, the
innermost of them the one whose self time it counts in.  Idle time in the
port is the part of the traced window in which nothing runs on the card
while some thread is inside a top-level ``xt.`` span (one inside no
other), less the time the profiler's own work (``PROFILER_OWN``) held the
host there: that gap comes once or twice a trace, 3-6 ms long, wherever
the profiler's buffer fills, and is not the port's.

``devtrace.Trace`` keeps only its reduction of the harness's trace, not
the events, so :func:`of` takes a trace of its own: ``trace_calls`` calls
after the harness's, on the same inputs, with the harness's labels and its
retake rule, once an observation.  Those calls run after the harness has
counted convergence warnings and checked for JAX, so :func:`_take` does
both again for them.  A program without spans (no ``xt.`` event in the
trace) reads None.
"""
import sys
import warnings

from portbench import devtrace, harness

PREFIX = "xt."
# host events of the profiler's own work
PROFILER_OWN = ("Activity Buffer Request",)


class Launch:
    """One kernel (or copy) the profiler linked to a host op: its name, the
    op's, device seconds, the names of the ``xt.`` spans that hold the op,
    and the innermost of them (None outside every span)."""

    def __init__(self, name, op, seconds, names, innermost):
        self.name, self.op, self.seconds = name, op, seconds
        self.names, self.innermost = names, innermost


class Spans:
    """The launches of ``calls`` traced calls, the span names seen, the
    idle seconds in the port, those left out of it as the profiler's own,
    and the trace's own device seconds (every event on the card, as
    ``devtrace`` counts them)."""

    def __init__(self, calls, launches, seen, idle_s, profiler_idle_s, device_s):
        self.calls, self.launches, self.seen = calls, launches, seen
        self.idle_s, self.profiler_idle_s, self.device_s = idle_s, profiler_idle_s, device_s

    def device_ms(self, names, self_only=False, skip=()):
        """Device ms a call of the launches under any span in ``names`` (with
        ``self_only``, those whose innermost span is one of them), leaving
        out kernels whose name holds a part in ``skip``; None where no span
        of ``names`` ran."""
        if not self.seen & set(names):
            return None
        sec = sum(k.seconds for k in self.launches
                  if (k.innermost in names if self_only else k.names & set(names))
                  and not any(p in k.name for p in skip))
        return 1e3 * sec / self.calls

    def outside(self):
        """{kernel name: device seconds} of the launches under no span."""
        out = {}
        for k in self.launches:
            if k.innermost is None:
                out[k.name] = out.get(k.name, 0.0) + k.seconds
        return out


def _inside(e, s):
    return (s.thread == e.thread and s.time_range.start <= e.time_range.start
            and e.time_range.end <= s.time_range.end)


def _intersect(a, b):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(intervals):
    return sum(b - a for a, b in intervals)


def _clip(events, lo, hi):
    """The union of the events' time ranges, clipped to [lo, hi]."""
    return devtrace._union([(max(lo, e.time_range.start), min(hi, e.time_range.end))
                            for e in events if e.time_range.end > lo and e.time_range.start < hi])


def reduce(events, calls):
    """The :class:`Spans` of the profiler's events (``prof.events()``) of a
    window of ``calls`` calls marked by ``devtrace.WINDOW``; None where the
    events hold no window or no ``xt.`` span."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name == devtrace.WINDOW]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [e for e in cpu if e.name.startswith(PREFIX)]
    if not marks or not spans:
        return None
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    launches, ids = [], set()
    for op in cpu:
        # a profiler overhead event may carry its op's id and kernels again
        if not op.kernels or op.id in ids:
            continue
        ids.add(op.id)
        held = [s for s in spans if _inside(op, s)]
        names = frozenset(s.name for s in held)
        inner = max(held, key=lambda s: s.time_range.start).name if held else None
        for k in op.kernels:
            if not k.name.startswith((PREFIX, "portbench.")):
                launches.append(Launch(k.name, op.name, k.duration * 1e-6, names, inner))
    # the card's busy intervals inside the window, as devtrace.reduce takes them
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and not e.name.startswith("portbench.")]
    busy = _clip(dev, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    top = [s for s in spans if not any(t is not s and _inside(s, t) for t in spans)]
    in_port = _intersect(idle, _clip(top, lo, hi))
    own = _length(_intersect(in_port, _clip([e for e in cpu if e.name in PROFILER_OWN], lo, hi)))
    device_s = sum((e.time_range.end - e.time_range.start) * 1e-6 for e in dev)
    return Spans(calls, launches, {s.name for s in spans},
                 (_length(in_port) - own) * 1e-6, own * 1e-6, device_s)


def _take(obs):
    """Profile ``trace_calls`` calls of the observation's entry and reduce
    them (None where every take lost the card's events or held no span)."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    import xitorch_tpu_torch as xt

    entry, calls = obs.entry, int(obs.traffic["trace_calls"])
    expect = [harness.roofline(k).NAME_PART for k in entry.kernels]
    sp = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for attempt in range(1, devtrace.TRIES + 1):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(devtrace.WINDOW):
                    for i in range(calls):
                        with record_function(devtrace.ISSUE):
                            entry.call(i % len(entry.sets))
                        with record_function(devtrace.SYNC):
                            torch.cuda.synchronize()
            events = prof.events()
            if devtrace._lost(devtrace.reduce(events, calls), expect) is None:
                sp = reduce(events, calls)
                break
            print("spans: trace %d of %d lost the card's events; taking it again"
                  % (attempt, devtrace.TRIES), file=sys.stderr)
        xt.linalg.flush_convergence_warnings()
    failed = sum(1 for w in caught if type(w.message).__name__ == "ConvergenceWarning")
    print("spans: %d traced call(s), %d convergence warning(s)" % (calls, failed), file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print("spans: the traced calls loaded %s (JAX or the JAX package)" % ", ".join(bad),
              file=sys.stderr)
        raise SystemExit(3)
    return sp


def _top(seconds_by_name, calls, n=6):
    top = sorted(seconds_by_name.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join("%s %.4f" % (k[:48], 1e3 * v / calls) for k, v in top)


def _report(sp):
    """Print where the device time of a call went: under the spans and
    outside them (by kernel), then each span's self time by op (ms a call)."""
    held = sum(k.seconds for k in sp.launches if k.names)
    print("spans: device ms a call under xt. spans %.4f of %.4f (%.2f %%); outside: %s"
          % (1e3 * held / sp.calls, 1e3 * sp.device_s / sp.calls, 100.0 * held / sp.device_s,
             _top(sp.outside(), sp.calls)), file=sys.stderr)
    print("spans: card idle ms a call in the port %.4f, and %.4f more while the profiler's "
          "own work held the host there (left out)"
          % (1e3 * sp.idle_s / sp.calls, 1e3 * sp.profiler_idle_s / sp.calls), file=sys.stderr)
    for name in sorted(sp.seen):
        own = {}
        for k in sp.launches:
            if k.innermost == name:
                own[k.op] = own.get(k.op, 0.0) + k.seconds
        print("spans: self %s %.4f: %s" % (name, 1e3 * sum(own.values()) / sp.calls,
                                            _top(own, sp.calls)), file=sys.stderr)


def of(obs):
    """The :class:`Spans` of the observation's entry, traced once (None
    without a trace of the card, or where the program has no span)."""
    if not hasattr(obs, "_spans"):
        obs._spans = None if obs.trace is None else _take(obs)
        if obs._spans is not None and obs._spans.device_s > 0:
            _report(obs._spans)
    return obs._spans
