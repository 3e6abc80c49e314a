"""chip_smoke.py's device timer by kernel name, with a stand-in profiler:
a trace that comes back with no event on the card is taken again, and a
timer that never sees one raises."""
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
        with pytest.raises(AssertionError, match="no event on the card"):
            smoke.device_ms_by_name(torch, fn, calls=10)
        assert len(taken) == smoke.PROFILE_TRIES
        return
    by_name = smoke.device_ms_by_name(torch, fn, calls=10)
    # 1,160 us over 10 calls is 0.116 ms a call; host events never count
    assert by_name == {"thomas_kernel<float>": pytest.approx(0.116)}
    assert smoke.kernel_ms(by_name, "thomas_kernel") == pytest.approx(0.116)
    assert len(taken) == empty_traces + 1
    # one warm-up call, then ten calls a trace
    assert len(calls) == 1 + 10 * (empty_traces + 1)
    assert capsys.readouterr().out.count("taking it again") == empty_traces
