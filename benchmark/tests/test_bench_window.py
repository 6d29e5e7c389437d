"""The window's arithmetic from recorded callback times, and the trace's reduction."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import tracing, window
from benchmark.window import Window, WindowClosed


class Clock:
    "A perf_counter that returns the times it is given, in turn."

    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


def cloud():
    return SimpleNamespace(eta=SimpleNamespace(t=torch.zeros(2, 3), c=torch.ones(2, 3)),
                           rho=torch.ones(2), theta=0.5)


def stub_fit(calls):
    "An entry that calls its callback `calls` times, then returns."
    def call(callback):
        for _ in range(calls):
            callback(cloud())
    return call


def test_iters_per_s_and_fit_start(monkeypatch):
    # fit called at 100.0; callbacks at 104.0, 104.5, ..., the last at 107.0 >= 100 + 7
    monkeypatch.setattr(window.time, "perf_counter",
                        Clock([100.0, 104.0, 104.5, 105.0, 106.0, 107.0]))
    win = Window(seconds=7.0, spc=10)
    win.run(stub_fit(50))
    assert win.fit_start_s == 4.0
    assert win.iters == 40  # four calls of ten after the first callback
    assert win.iters_per_s == 40 / 3.0
    assert win.first.theta == 0.5


def test_window_of_zero_closes_at_the_first_callback(monkeypatch):
    monkeypatch.setattr(window.time, "perf_counter", Clock([0.0, 3.0]))
    win = Window(seconds=0.0, spc=10)
    win.run(stub_fit(5))
    assert len(win.times) == 1
    with pytest.raises(RuntimeError, match="second callback"):
        win.iters_per_s


def test_a_fit_that_ends_before_the_window_is_an_error():
    with pytest.raises(RuntimeError, match="raise niter"):
        Window(seconds=1e9, spc=10).run(stub_fit(2))


def test_the_callback_raises_its_own_exception():
    win = Window(seconds=0.0, spc=10)
    win.t_call = 0.0
    with pytest.raises(WindowClosed):
        win.callback(cloud())


class Event:
    def __init__(self, name, device, start, end):
        self.name, self.device_type = name, device
        self.time_range = SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)


def test_trace_reduction():
    C, G = DeviceType.CPU, DeviceType.CUDA
    events = [
        Event(tracing.MARK, C, 0.0, 1.0),
        Event("cudaGraphLaunch", C, 1.0, 5.0),
        Event("void smc_forward_kernel<16, 4>", G, 10.0, 110.0),
        Event("void smc_backward_kernel<16, 4>", G, 112.0, 312.0),  # a 2 us gap: short
        Event("Memset (Device)", G, 312.0, 313.0),
        Event("aten::item", C, 300.0, 500.0),
        Event("cudaStreamSynchronize", C, 320.0, 480.0),  # innermost over the long gap
        Event("void assembly_forward_kernel<float>", G, 500.0, 520.0),
        Event("kernel outside", G, 2000.0, 2100.0),  # after the window
        Event(tracing.MARK, C, 1000.0, 1001.0),
    ]
    tr = tracing.reduce(events, calls=2, spc=10, wall=0.0)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx((100 + 200 + 1 + 20) * 1e-6)
    assert tr.kernels == 3 and tr.iters == 20 and tr.calls == 2
    assert tr.seconds_of(tracing.HMM_KERNELS) == pytest.approx(300e-6)
    assert tr.gaps[tracing.SHORT_GAP] == pytest.approx(2e-6)
    assert tr.gaps["cudaStreamSynchronize"] == pytest.approx(187e-6)
    assert tr.gaps["cudaGraphLaunch"] == pytest.approx(10e-6)  # the mark to the first kernel
    assert tr.gaps["no traced host op"] == pytest.approx(480e-6)
    b = tracing.breakdown(tr, top=2)
    assert [n for n, _ in b["device_ops"]] == ["void smc_backward_kernel<16, 4>",
                                               "void smc_forward_kernel<16, 4>"]
    assert len(b["idle_gaps"]) == 2
