"""The port's own spans and kernel counts (``xitorch_tpu_torch/debug/profiling.py``)
and the benchmark's readers of them (``portbench/spans.py``,
``portbench/counts.py``), on the CPU.

Under ``torch.profiler`` a structured solve (forward, then gradient) and an
exacteig symeig hold the ``xt.`` spans, nested as the module's docstring
lists them; with no profiler running ``span`` is one shared no-op and no
``record_function`` runs; ``torch.export`` keeps no profiler op; the count
lists grow by one entry a kernel call only while a profiler records.  The
readers are held to hand-computed totals on synthetic profiler events."""
import math
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import xitorch_tpu_torch as xt
import xitorch_tpu_torch.serving as serving
from xitorch_tpu_torch.debug import profiling
from xitorch_tpu_torch.ops import jacobi_eigh, structured_cg
from portbench import counts, devtrace, spans

torch.set_num_threads(1)

K, N = 6, 48


def _structured(seed=0):
    gen = torch.Generator().manual_seed(seed)
    d = (4 + 2 * torch.rand(K, N, generator=gen)).requires_grad_(True)
    V = (torch.randn(K, N, 2, generator=gen) / math.sqrt(N)).requires_grad_(True)
    b = torch.randn(K, N, 1, generator=gen)
    return d, torch.tensor(1.0), V, b


def _spd(seed=1, B=2, n=16):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(B, n, n, generator=gen) / math.sqrt(n)
    return a @ a.mT + 2 * torch.eye(n)


def _xt_parent(e):
    """The nearest enclosing ``xt.`` span of a profiler event (None if none)."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("xt."):
        p = p.cpu_parent
    return p


def test_solve_forward_and_gradient_hold_the_spans_nested():
    d, c, V, b = _structured()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = xt.linalg.solve(xt.TridiagLowRankOperator(d, c, V), b, method="structured_cg")
        torch.autograd.grad((x * x).sum(), [d, V])
    ev = [e for e in prof.events() if e.name.startswith("xt.")]
    tree = [(e.name, None if _xt_parent(e) is None else _xt_parent(e).name) for e in ev]
    assert tree == [
        ("xt.solve", None),
        ("xt.solve.pending", "xt.solve"),
        ("xt.solve.method", "xt.solve"),
        ("xt.solve.check", "xt.solve"),
        ("xt.solve.backward", None),
        ("xt.solve", "xt.solve.backward"),
        ("xt.solve.pending", "xt.solve"),
        ("xt.solve.method", "xt.solve"),
        ("xt.solve.check", "xt.solve"),
    ]
    # the kernel's operator runs inside the dispatcher's span
    kernel = [e for e in prof.events() if e.name == "xitorch_tpu_torch::structured_cg"]
    assert len(kernel) == 2 and all(_xt_parent(e).name == "xt.solve.method" for e in kernel)


def test_symeig_exacteig_holds_its_spans_nested():
    A = xt.LinearOperator.m(_spd(), is_hermitian=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        xt.linalg.symeig(A, 3, "lowest", method="exacteig")
    ev = [e for e in prof.events() if e.name.startswith("xt.")]
    assert [(e.name, None if _xt_parent(e) is None else _xt_parent(e).name)
            for e in ev] == [("xt.symeig", None), ("xt.symeig.method", "xt.symeig")]


def test_no_profiler_means_the_shared_noop_and_no_record_function(monkeypatch):
    assert profiling.span("xt.solve") is profiling.span("xt.symeig.method")
    entered = []
    monkeypatch.setattr(profiling, "_RecordFunctionFast", lambda *a: entered.append(a))
    monkeypatch.setattr(profiling, "record_function", lambda *a: entered.append(a))
    d, c, V, b = _structured()
    x = xt.linalg.solve(xt.TridiagLowRankOperator(d, c, V), b, method="structured_cg")
    torch.autograd.grad(x.sum(), [d])
    xt.linalg.symeig(xt.LinearOperator.m(_spd(), is_hermitian=True), 2, method="exacteig")
    assert entered == []


def test_export_under_a_profiler_holds_no_profiler_op():
    d, c, V, b = _structured()
    args = (d.detach(), V.detach(), b)

    def fn(d, V, b):
        return xt.linalg.solve(xt.TridiagLowRankOperator(d, torch.tensor(1.0), V), b,
                               method="structured_cg")

    before = len(profiling.counts("structured_cg"))
    with profile(activities=[ProfilerActivity.CPU]):
        ep = serving._export(fn, args)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert any("structured_cg" in t for t in targets)
    assert not any("profiler" in t or "record_function" in t for t in targets)
    assert len(profiling.counts("structured_cg")) == before


def test_counts_kept_only_while_a_profiler_records(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    d, c, V, b = _structured()
    dl = torch.full((K, N), 1.0)
    flat = (d.detach(), dl, dl, V.detach(), b[..., 0])
    panel = jacobi_eigh._shift_pad(_spd(B=3, n=32), jacobi_eigh._padded_n(32))
    structured_cg.structured_cg_solve(*flat)
    jacobi_eigh.jacobi_sweep(panel, 18, 1e-6)
    assert profiling.counts("structured_cg") == profiling.counts("jacobi_sweep") == []
    with profile(activities=[ProfilerActivity.CPU]):
        _, it, _ = structured_cg.structured_cg_solve(*flat)
        _, sweeps = jacobi_eigh.jacobi_sweep(panel, 18, 1e-6)
        # the complex sweep kernel keeps its own count (jacobi_sweeps_complex reads it)
        _, csweeps = jacobi_eigh.jacobi_sweep(torch.cat([panel, torch.zeros_like(panel)], -1),
                                              18, 1e-6, complexpair=True)
    kept_cg, kept_sw = profiling.counts("structured_cg"), profiling.counts("jacobi_sweep")
    assert len(kept_cg) == len(kept_sw) == 1
    assert set(profiling._COUNTS) == {"structured_cg", "jacobi_sweep", "jacobi_sweep_complex"}
    assert [torch.equal(t, csweeps) for t in profiling.counts("jacobi_sweep_complex")] == [True]
    # the kept entries are the plain versions' own counts
    Vf = V.detach().transpose(1, 2).contiguous()
    _, it_plain, _ = structured_cg.structured_cg_plain(
        d.detach(), dl[:, None], dl[:, None], Vf, b[..., 0], (1,), rtol=1e-6, atol=1e-8,
        max_niter=2 * N)
    _, sweeps_plain = jacobi_eigh.jacobi_sweep_plain(panel, 18, 1e-6)
    assert torch.equal(kept_cg[-1], it) and torch.equal(kept_cg[-1], it_plain)
    assert torch.equal(kept_sw[-1], sweeps) and torch.equal(kept_sw[-1], sweeps_plain)
    assert counts.mean_per_system("jacobi_sweep") == pytest.approx(
        float(sum(t.double().sum() for t in kept_sw)) / sum(t.numel() for t in kept_sw))


def test_complex_sweep_count_kept_only_while_a_profiler_records(monkeypatch):
    """The complex kernel's per-matrix sweeps, the plain version's own, are
    kept under ``jacobi_sweep_complex`` while a profiler records, and not
    otherwise."""
    monkeypatch.setattr(profiling, "_COUNTS", {})
    h = _spd(B=3, n=32).to(torch.complex64)
    h = h + 0.1j * (h.real.tril(-1) - h.real.triu(1))
    a = jacobi_eigh._shift_pad(h, 32)
    cpanel = torch.cat([a.real, -a.imag], -1)
    jacobi_eigh.jacobi_sweep(cpanel, 18, 1e-6, complexpair=True)
    assert profiling.counts("jacobi_sweep_complex") == [] and profiling._COUNTS == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _, sweeps = jacobi_eigh.jacobi_sweep(cpanel, 18, 1e-6, complexpair=True)
    _, plain = jacobi_eigh.jacobi_sweep_plain(cpanel, 18, 1e-6, complexpair=True)
    kept = profiling.counts("jacobi_sweep_complex")
    assert len(kept) == 1 and torch.equal(kept[0], sweeps) and torch.equal(kept[0], plain)
    assert set(profiling._COUNTS) == {"jacobi_sweep_complex"}
    assert counts.mean_per_system("jacobi_sweep_complex") == pytest.approx(
        float(plain.double().mean()))


def test_degen_eigh_backward_holds_its_span_only_under_a_profiler(monkeypatch):
    """``xt.symeig.backward`` wraps ``degen_eigh``'s backward under a
    profiler, outside the forward's spans; without one the span is the
    shared no-op and no profiler range is entered."""
    A = _spd().to(torch.complex64).requires_grad_(True)
    op = xt.LinearOperator.m(A, is_hermitian=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        evals, _ = xt.linalg.symeig(op, 16, "lowest", method="exacteig")
        torch.autograd.grad((evals[:, 7:9] ** 2).sum(), [A])
    ev = [e for e in prof.events() if e.name.startswith("xt.")]
    assert [(e.name, None if _xt_parent(e) is None else _xt_parent(e).name) for e in ev] == [
        ("xt.symeig", None), ("xt.symeig.method", "xt.symeig"), ("xt.symeig.backward", None)]
    back = [e for e in prof.events() if e.name == "xt.symeig.backward"][0]
    assert any(_xt_parent(e) is back for e in prof.events() if "matmul" in e.name)
    entered = []
    monkeypatch.setattr(profiling, "_RecordFunctionFast", lambda *a: entered.append(a))
    evals, _ = xt.linalg.symeig(xt.LinearOperator.m(A, is_hermitian=True), 16, "lowest",
                                method="exacteig")
    (g,) = torch.autograd.grad((evals[:, 7:9] ** 2).sum(), [A])
    assert entered == [] and torch.isfinite(torch.view_as_real(g)).all()


def test_count_list_is_bounded_oldest_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    key = "structured_cg"
    assert counts.mean_per_system(key) is None
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.COUNT_KEEP + 3):
            profiling.count(key, torch.tensor([i, i + 1]))
    kept = profiling.counts(key)
    assert len(kept) == profiling.COUNT_KEEP
    assert int(kept[0][0]) == 3 and int(kept[-1][0]) == profiling.COUNT_KEEP + 2
    assert len(profiling.counts(key)) == profiling.COUNT_KEEP  # read, not cleared
    # the mean over every system of the kept calls
    assert counts.mean_per_system(key) == 3 + (profiling.COUNT_KEEP - 1) / 2 + 0.5


# ------------------------------------------------------------------
# the benchmark's readers on synthetic profiler events (times in us)
# ------------------------------------------------------------------

def _ev(name, lo, hi, thread=1, dev=DeviceType.CPU, kernels=(), id=0, ua=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=lo, end=hi),
                           thread=thread, device_type=dev, id=id, is_user_annotation=ua,
                           kernels=[SimpleNamespace(name=k, duration=us) for k, us in kernels])


def _card(name, lo, hi):
    return _ev(name, lo, hi, thread=7, dev=DeviceType.CUDA)


def _events(with_spans=True):
    """A forward call on thread 1 and its backward on thread 2: the kernels'
    host ops, their events on the card, and (``with_spans``) the program's
    spans on the host and as annotations on the card's timeline."""
    ops = [
        _ev("aten::cat", 13, 14, kernels=[("cat_kernel", 5)], id=1),
        # a profiler overhead event that carries its op's id and kernel again
        _ev("Activity Buffer Request", 13.2, 13.8, kernels=[("cat_kernel", 5)], id=1),
        _ev("aten::mm", 32, 33, kernels=[("gemv", 7)], id=2),
        _ev("aten::add", 46, 47, kernels=[("add_kernel", 2)], id=3),
        _ev("aten::mm", 56, 57, thread=2, kernels=[("mm_kernel", 4)], id=4),
        _ev("aten::mm", 71, 72, thread=2, kernels=[("gemv", 3)], id=5),
        _ev("aten::sum", 92, 93, kernels=[("sum_kernel", 1)], id=6),
    ]
    card = [_card("cat_kernel", 15, 20), _card("gemv", 35, 42), _card("add_kernel", 48, 50),
            _card("mm_kernel", 58, 62), _card("gemv", 72, 75), _card("sum_kernel", 93, 94)]
    host = [_ev(devtrace.WINDOW, 0, 100), _ev(devtrace.ISSUE, 5, 51)]
    if with_spans:
        host += [_ev("xt.solve", 10, 50), _ev("xt.solve.method", 12, 30),
                 _ev("xt.solve.check", 31, 45),
                 _ev("xt.solve.backward", 55, 90, thread=2), _ev("xt.solve", 60, 80, thread=2),
                 _ev("xt.solve.check", 70, 75, thread=2)]
        card += [_ev("xt.solve", 15, 50, thread=7, dev=DeviceType.CUDA, ua=True),
                 _ev("xt.solve.backward", 58, 75, thread=7, dev=DeviceType.CUDA, ua=True)]
    return sorted(host + ops + card, key=lambda e: e.time_range.start)


def test_span_device_and_self_time_by_hand():
    sp = spans.reduce(_events(), calls=1)
    us = 1e-3  # ms
    assert sp.device_ms({"xt.solve.check"}) == pytest.approx((7 + 3) * us)
    assert sp.device_ms({"xt.solve.method"}) == pytest.approx(5 * us)
    assert sp.device_ms({"xt.solve.method"}, skip=("cat",)) == 0.0
    # the forward's ops and the adjoint's check, each counted once
    assert sp.device_ms({"xt.solve"}) == pytest.approx((5 + 7 + 2 + 3) * us)
    assert sp.device_ms({"xt.solve.backward"}) == pytest.approx((4 + 3) * us)
    assert sp.device_ms({"xt.solve.backward"}, self_only=True) == pytest.approx(4 * us)
    assert sp.device_ms({"xt.solve"}, self_only=True) == pytest.approx(2 * us)
    assert sp.device_ms({"xt.symeig.method"}) is None
    assert sp.outside() == {"sum_kernel": pytest.approx(1e-6)}
    assert sp.device_s == pytest.approx(22e-6)


def test_idle_in_port_by_hand_with_a_span_on_a_second_thread():
    sp = spans.reduce(_events(), calls=2)
    # idle gaps of the window [0, 100] against the top-level spans [10, 50]
    # (thread 1) and [55, 90] (thread 2): 5 + 15 + 6, then 3 + 10 + 15, less
    # the profiler's own buffer request at [13.2, 13.8]
    assert sp.idle_s == pytest.approx(53.4e-6)
    assert sp.profiler_idle_s == pytest.approx(0.6e-6)
    assert sp.device_ms({"xt.solve.check"}) == pytest.approx(0.005)  # a call of two


def test_idle_in_port_leaves_out_only_the_profilers_own_work_inside_spans():
    own = spans.PROFILER_OWN[0]
    extra = [_ev(own, 22, 30, id=9),  # in xt.solve, the card idle: left out
             _ev(own, 36, 40, id=10),  # in xt.solve, the card busy (gemv): no idle
             _ev(own, 60, 68, thread=2, id=11),  # in the backward, idle from 62
             _ev(own, 95, 99, id=12)]  # outside every span: never the port's
    sp = spans.reduce(sorted(_events() + extra, key=lambda e: e.time_range.start), calls=1)
    assert sp.profiler_idle_s == pytest.approx((0.6 + 8 + 6) * 1e-6)
    assert sp.idle_s == pytest.approx((54 - 0.6 - 8 - 6) * 1e-6)
    # device times are unchanged by the profiler's host events
    assert sp.device_ms({"xt.solve.check"}) == pytest.approx((7 + 3) * 1e-3)


def test_no_span_reads_none():
    assert spans.reduce(_events(with_spans=False), calls=1) is None


def test_trace_fields_unchanged_by_the_spans():
    plain, spanned = devtrace.reduce(_events(False), 1), devtrace.reduce(_events(True), 1)
    assert spanned.by_name == plain.by_name
    assert (spanned.busy_s, spanned.window_s) == (plain.busy_s, plain.window_s)
    assert [s for s, _ in spanned.gaps] == [s for s, _ in plain.gaps]
    # a gap's label names the program's span where one now covers it
    for (_, a), (_, b) in zip(plain.gaps, spanned.gaps):
        assert b == a or b.startswith("xt.")
    assert any(b.startswith("xt.") for _, b in spanned.gaps)


def test_reduce_reads_a_real_cpu_trace():
    d, c, V, b = _structured()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function(devtrace.WINDOW):
            x = xt.linalg.solve(xt.TridiagLowRankOperator(d, c, V), b, method="structured_cg")
            torch.autograd.grad(x.sum(), [d])
    sp = spans.reduce(prof.events(), calls=1)
    assert {"xt.solve", "xt.solve.method", "xt.solve.check", "xt.solve.backward"} <= sp.seen
    # no kernel on the card: every span reads 0 device ms, the card idles
    # through all of them
    assert sp.device_ms({"xt.solve.check"}) == 0.0 and sp.launches == []
    assert sp.idle_s > 0
