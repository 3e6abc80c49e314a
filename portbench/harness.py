"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, entry,
reference, per-layer metric or kernel lives in a file of its own under
``portbench/``, found by the names in ``BENCHMARK.json``; nothing here
names a cell.
"""
import gc
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "xitorch_tpu")
# the program's caches the benchmark points inside the checkout, each at a
# fixed path
CACHE_ENV = ("CUDA_CACHE_PATH", "PYTORCH_KERNEL_CACHE_PATH", "TRITON_CACHE_DIR",
             "TORCH_EXTENSIONS_DIR")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _named(items, name, what):
    hits = [it for it in items if it["name"] == name]
    if len(hits) != 1:
        raise SystemExit("portbench: no %s named %r in BENCHMARK.json" % (what, name))
    return hits[0]


def _applies(metric, workload):
    return workload in metric.get("workloads", [workload])


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic mix,
    limits and metrics.  ``traffic`` may be replaced (the tests shrink it)."""

    def __init__(self, name, bench=None, root=ROOT):
        bench = bench if bench is not None else load_json(os.path.join(root, "BENCHMARK.json"))
        self.name = name
        self.workload = _named(bench["workloads"], name, "workload")
        conf = _named(bench["configs"], self.workload["config"], "config")
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(HERE, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(HERE, "limits", name + ".json"))
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]

    def entry_module(self):
        return importlib.import_module("portbench.entries." + self.traffic["entry"])

    def reference(self):
        return importlib.import_module("portbench.reference." + self.config["reference"])


def roofline(kernel):
    return importlib.import_module("portbench.rooflines." + kernel)


def port_kernel_parts():
    """The name parts of every port kernel that has a count file."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "rooflines"))
                   if f.endswith(".py") and not f.startswith("_"))
    return [roofline(k).NAME_PART for k in names]


def peaks():
    return load_json(os.path.join(HERE, "rooflines", "peaks.json"))


class Window:
    """The measured calls: their count, the window's length, each call's
    latency (CUDA events, ms), each call's host issue span (s), and the port's
    launches over the window."""

    def __init__(self, calls, window_s, latency_ms, issue_s, launches):
        self.calls, self.window_s = calls, window_s
        self.latency_ms, self.issue_s, self.launches = latency_ms, issue_s, launches


def run_window(torch, entry, seconds, keep, start_set=0, cuda=True):
    """Call the entry back to back, each call ended by a synchronise, until
    ``seconds`` have passed (and each input set has had a call); the input
    sets are used in turn and the last outputs on each are kept in ``keep``.
    Each call's latency is taken by CUDA events on the stream (without
    ``cuda``, for rehearsals and tests on the CPU, by the host clock)."""
    sets = len(entry.sets)
    latency, issue = [], []
    launches0 = entry.launches()
    clock = time.perf_counter
    t0 = clock()
    i = 0
    while True:
        s = (start_set + i) % sets
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        a = clock()
        out = entry.call(s)
        b = clock()
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
        t = clock()
        keep[s] = out
        latency.append(ev if cuda else 1e3 * (b - a))
        issue.append(b - a)
        i += 1
        if t - t0 >= seconds and i >= sets:
            break
    if cuda:
        latency = [e0.elapsed_time(e1) for e0, e1 in latency]
    return Window(i, t - t0, latency, issue, entry.launches() - launches0)


def p95(values):
    return statistics.quantiles(values, n=100, method="inclusive")[94]


class Observation:
    """What the per-layer readers (``portbench/metrics/``) read: the window,
    the trace (None where none held the card's events), the peak device
    memory, the cell's configuration and traffic, the entry (with its
    kernels), and the card's peaks."""

    def __init__(self, cell, entry, window, trace, peak_bytes):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.entry, self.window, self.trace = entry, window, trace
        self.peak_bytes, self.peaks = peak_bytes, peaks()

    def roofline_share(self, kernel):
        """Percent: the least time of the kernel's launches in the trace over
        their device time; None where the trace holds none of them."""
        if self.trace is None:
            return None
        mod = roofline(kernel)
        seconds, launches = self.trace.matching(mod.NAME_PART)
        if launches == 0 or seconds <= 0:
            return None
        least, _ = mod.least_seconds(self.cfg, self.traffic, self.peaks)
        return 100.0 * least * launches / seconds


def read_metric(name, obs):
    return importlib.import_module("portbench.metrics." + name).read(obs)


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read (nvidia-smi failed)"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(cell, entry, keep):
    """The compared numbers, each the widest over the kept calls (the last
    call on each input set, every system of it), with its limit."""
    ref = cell.reference()
    worst = {}
    for s in range(len(entry.sets)):
        for key, v in ref.judge(cell.config, cell.traffic, entry.sets[s], keep[s]).items():
            v = v if v == v else float("inf")
            worst[key] = max(v, worst.get(key, 0.0))
    checks = {}
    for key, v in worst.items():
        lim = cell.limits.get(key, {}).get("limit")
        checks[key] = {"value": v, "limit": lim}
    correct = bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"]
                                   for c in checks.values())
    return correct, checks


def imported_since(before):
    """The modules imported since ``before`` (a set of names), counted by
    package, the largest first."""
    new = [m for m in sys.modules if m not in before]
    by = {}
    for m in new:
        top = ".".join(m.split(".")[:2])
        by[top] = by.get(top, 0) + 1
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    return "%d modules: %s" % (len(new), ", ".join("%s %d" % kv for kv in top))


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


def run(cell, seed, seconds, trace, t_start, device="cuda"):
    """One run of ``cell``: returns ``(exit code, result dict or None)``.
    ``t_start`` is the process's start on ``time.perf_counter``."""
    for var in CACHE_ENV:
        os.environ[var] = os.path.join(HERE, "out", "cache", var.lower())
    import torch

    t_torch = time.perf_counter()
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            _log("portbench: the cell needs %d CUDA device(s); torch sees %d"
                 % (cell.chips, torch.cuda.device_count() if torch.cuda.is_available() else 0))
            return 2, None
        torch.cuda.init()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t_cuda = time.perf_counter()
    module = cell.entry_module()
    t_import = time.perf_counter()
    entry = module.make(cell.config, cell.traffic, int(seed), torch.device(device))
    sync()
    t_inputs = time.perf_counter()
    keep = {}
    warm = int(cell.traffic["warmup_calls"])
    sets = len(entry.sets)
    modules = set(sys.modules)
    keep[0] = entry.call(0)
    sync()
    t_first = time.perf_counter()
    modules = imported_since(modules)
    for i in range(1, warm):
        keep[i % sets] = entry.call(i % sets)
        sync()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    _log("setup: %.3f s: import torch %.3f s, CUDA start %.3f s, the port's modules %.3f s, "
         "inputs %.3f s, first call (loads the port's kernel libraries, builds them if the "
         "checkout has none; it imported %s) %.3f s, %d more warm-up call(s) %.3f s"
         % (setup_s, t_torch - t_start, t_cuda - t_torch, t_import - t_cuda,
            t_inputs - t_import, modules, t_first - t_inputs, warm - 1, t_warm - t_first))

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        window = run_window(torch, entry, seconds, keep, warm % sets, device == "cuda")
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        tr = None
        if trace and device == "cuda":
            from portbench import devtrace

            tr = trace_segment(torch, cell, entry, keep, devtrace)
        import xitorch_tpu_torch as xt

        xt.linalg.flush_convergence_warnings()
    failed = sum(1 for w in caught if type(w.message).__name__ == "ConvergenceWarning")
    bad = forbidden_modules()
    if bad:
        _log("portbench: the run loaded %s (JAX or the JAX package)" % ", ".join(bad))
        return 3, None

    obs = Observation(cell, entry, window, tr, peak)
    metrics, lines = {}, []
    if trace:
        card = card_line() if device == "cuda" else "CPU rehearsal"
        for m in cell.per_layer:
            v = read_metric(m["name"], obs)
            if v is None:
                lines.append("per-layer %s: not measured" % m["name"])
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            lines.append("per-layer %s: %r %s (%s)" % (m["name"], v, m["unit"], card))
    else:
        e2e = {"systems_per_s": window.calls * entry.systems / window.window_s,
               "call_ms_p95": p95(window.latency_ms) if len(window.latency_ms) > 1
               else window.latency_ms[0],
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
            lines.append("end-to-end %s: %r %s" % (m["name"], e2e[m["name"]], m["unit"]))
    _log("window: %d calls of %d systems in %.6f s; %d convergence warning(s)"
         % (window.calls, entry.systems, window.window_s, failed))
    for line in lines:
        _log(line)

    # the reference runs once the window has closed and the peak is read,
    # with the program's transient memory handed back
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    correct, checks = judge(cell, entry, keep)
    _log("reference: %.3f s" % (time.perf_counter() - t_ref))
    result = {"correct": correct, "attempted": window.calls, "failed": failed,
              "metrics": metrics, "device": device_info(torch, device, cell.chips, peak, tr)}
    if tr is not None:
        result["breakdown"] = breakdown(tr)
    result["checks"] = checks
    for key, c in checks.items():
        _log("check %s: %r (limit %r)" % (key, c["value"], c["limit"]))
    return 0, result


def trace_segment(torch, cell, entry, keep, devtrace):
    """Profile ``trace_calls`` calls after the window (the window itself runs
    without the profiler)."""
    from torch.autograd.profiler import record_function

    sets = len(entry.sets)
    state = {"i": 0}

    def one_call():
        s = state["i"] % sets
        with record_function(devtrace.ISSUE):
            out = entry.call(s)
        with record_function(devtrace.SYNC):
            torch.cuda.synchronize()
        keep[s] = out
        state["i"] += 1

    expect = [roofline(k).NAME_PART for k in entry.kernels]
    return devtrace.trace_calls(torch, one_call, int(cell.traffic["trace_calls"]), expect)


def device_info(torch, device, chips, peak, tr):
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak}
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def breakdown(tr):
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[name, sec / tr.calls] for name, (sec, _) in ops],
            "idle_gaps": [[what, sec] for sec, what in tr.gaps[:10]]}
