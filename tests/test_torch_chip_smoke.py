"""chip_smoke.py's device timer by kernel name, with a stand-in profiler:
a trace that comes back with no event on the card, or without the kernel
it was asked to find, is taken again, and a timer that never sees one
times the call by CUDA events instead (the rule for a profiler that shows
no device time), which gives no device busy time and no idle share."""
import importlib.util
import os

import pytest
import torch
from torch.autograd import DeviceType


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class _Event:
    def __init__(self, key, device_type, us, count=10):
        self.key, self.device_type, self.self_device_time_total = key, device_type, us
        self.count = count  # launches in the trace (one a call over 10 calls)


def _fake_profiler(traces):
    """A ``torch.profiler.profile`` stand-in whose n-th trace holds
    ``traces[n]`` (the last one repeats), and the count of traces taken."""
    taken = []

    class Profile:
        def __init__(self, activities):
            self.events = traces[min(len(taken), len(traces) - 1)]
            taken.append(1)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    return Profile, taken


@pytest.mark.parametrize("empty_traces", [0, 1, 2, 3])
def test_device_ms_by_name_retakes_a_trace_with_no_event_on_the_card(
        monkeypatch, capsys, empty_traces):
    smoke = _smoke()
    host_only = [_Event("aten::add", DeviceType.CPU, 900.0)]
    full = host_only + [_Event("thomas_kernel<float>", DeviceType.CUDA, 1160.0)]
    profile, taken = _fake_profiler([host_only] * empty_traces + [full])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []

    def fn():
        calls.append(1)

    if empty_traces >= smoke.PROFILE_TRIES:
        # every trace lost the card: the call's time by CUDA events stands in
        events = []
        monkeypatch.setattr(smoke, "timed_ms", lambda torch, fn, **kw: events.append(kw) or 0.25)
        by_name = smoke.device_ms_by_name(torch, fn, calls=10)
        assert by_name == {smoke.EVENTS_KEY: 0.25}
        assert smoke.kernel_ms(by_name, "thomas_kernel") == 0.25
        assert events == [{"reps": 10, "inner": smoke.INNER, "warmup": False}]
        assert len(taken) == smoke.PROFILE_TRIES
        assert "timed by CUDA events instead" in capsys.readouterr().out
        return
    by_name = smoke.device_ms_by_name(torch, fn, calls=10)
    # 1,160 us over 10 calls is 0.116 ms a call; host events never count
    assert by_name == {"thomas_kernel<float>": pytest.approx(0.116)}
    assert smoke.kernel_ms(by_name, "thomas_kernel") == pytest.approx(0.116)
    assert len(taken) == empty_traces + 1
    # one warm-up call, then ten calls a trace
    assert len(calls) == 1 + 10 * (empty_traces + 1)
    assert capsys.readouterr().out.count("taking it again") == empty_traces


@pytest.mark.parametrize("lost_traces", [1, 3])
def test_device_ms_by_name_retakes_a_trace_that_lost_the_expected_kernel(
        monkeypatch, capsys, lost_traces):
    # late in a long process a trace may hold PyTorch's kernels but not
    # those this package launches through ctypes
    smoke = _smoke()
    torch_only = [_Event("void at::native::vectorized_elementwise_kernel", DeviceType.CUDA,
                         200.0)]
    full = torch_only + [_Event("thomas_kernel<float>", DeviceType.CUDA, 1160.0)]
    profile, taken = _fake_profiler([torch_only] * lost_traces + [full])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(smoke, "timed_ms", lambda torch, fn, **kw: 0.5)
    busy = smoke.device_busy_ms(torch, lambda: None, calls=10, expect=("thomas_kernel",))
    if lost_traces >= smoke.PROFILE_TRIES:
        # the events fallback timed the whole call: no device busy time
        assert busy is None and len(taken) == smoke.PROFILE_TRIES
    else:
        assert busy == pytest.approx(0.136) and len(taken) == lost_traces + 1
    assert capsys.readouterr().out.count("no event of ['thomas_kernel']") == min(
        lost_traces, smoke.PROFILE_TRIES)
    # without ``expect`` the first trace with any event on the card counts
    profile, taken = _fake_profiler([torch_only, full])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    assert smoke.device_busy_ms(torch, lambda: None, calls=10) == pytest.approx(0.02)


@pytest.mark.parametrize("top", [0, 3])
def test_no_idle_share_from_the_events_fallback(monkeypatch, capsys, top):
    """A trace with no event on the card in every retake: the call is timed
    by CUDA events, and no busy time or idle share is printed or recorded
    from that time (it holds the host's time too)."""
    smoke = _smoke()
    profile, _ = _fake_profiler([[_Event("aten::add", DeviceType.CPU, 900.0)]])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(smoke, "timed_ms", lambda torch, fn, **kw: 0.8)
    out = smoke.device_busy_ms(torch, lambda: None, calls=5, top=top)
    busy = out[0] if top else out
    assert busy is None
    if top:
        assert out[1] == [(smoke.EVENTS_KEY, 0.8)]
    assert smoke.idle_share(busy, 1.0) is None
    assert smoke.busy_text(busy, 1.0) == ("device busy and idle share not measured "
                                          "(the profiler lost the card)")
    assert "idle share 20%" in smoke.busy_text(0.8, 1.0)
    assert smoke.idle_share(0.8, 1.0) == pytest.approx(0.2)
    assert "timed by CUDA events instead" in capsys.readouterr().out


@pytest.mark.parametrize("lost", [0, 1, 3])
def test_launches_by_name_retakes_a_trace_that_lost_launches(monkeypatch, capsys, lost):
    """Launches a call counted from the profiler's events: a trace that
    lost some (2 of 5 calls' launches, as late in a long process) is taken
    again; where every trace lost some, the count is not measured (None)."""
    smoke = _smoke()

    def kernel(count):
        return [_Event("structured_cg_reg_kernel", DeviceType.CUDA, 100.0, count),
                _Event("aten::add", DeviceType.CPU, 900.0)]

    profile, taken = _fake_profiler([kernel(2)] * lost + [kernel(5)])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    got = smoke.launches_by_name(torch, lambda: None, "structured_cg_reg", calls=5)
    if lost >= smoke.PROFILE_TRIES:
        assert got is None and len(taken) == smoke.PROFILE_TRIES
    else:
        assert got == 1 and len(taken) == lost + 1
    assert capsys.readouterr().out.count("taking it again") == min(lost, smoke.PROFILE_TRIES)


def test_device_ms_by_name_retakes_a_trace_that_lost_some_launches(monkeypatch, capsys):
    """Late in a long process a trace may hold only some launches of an
    expected kernel (4 of 10 calls'): such a trace is taken again, since its
    time by name would be a share of the kernel's."""
    smoke = _smoke()
    partial = [_Event("thomas_kernel<float>", DeviceType.CUDA, 464.0, count=4)]
    full = [_Event("thomas_kernel<float>", DeviceType.CUDA, 1160.0, count=10)]
    profile, taken = _fake_profiler([partial, full])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    by_name = smoke.device_ms_by_name(torch, lambda: None, calls=10, expect=("thomas_kernel",))
    assert by_name == {"thomas_kernel<float>": pytest.approx(0.116)} and len(taken) == 2
    assert "not every call's launches of ['thomas_kernel']" in capsys.readouterr().out
