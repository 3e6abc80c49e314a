"""chip_smoke.py's device timer by kernel name, with a stand-in profiler:
a trace that comes back with no event on the card, or without the kernel
it was asked to find, is taken again, and a timer that never sees one
times the call by CUDA events instead (the rule for a profiler that shows
no device time)."""
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
    def __init__(self, key, device_type, us):
        self.key, self.device_type, self.self_device_time_total = key, device_type, us


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
        assert busy == 0.5 and len(taken) == smoke.PROFILE_TRIES
    else:
        assert busy == pytest.approx(0.136) and len(taken) == lost_traces + 1
    assert capsys.readouterr().out.count("no event of ['thomas_kernel']") == min(
        lost_traces, smoke.PROFILE_TRIES)
    # without ``expect`` the first trace with any event on the card counts
    profile, taken = _fake_profiler([torch_only, full])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    assert smoke.device_busy_ms(torch, lambda: None, calls=10) == pytest.approx(0.02)
