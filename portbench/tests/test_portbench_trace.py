"""The reduction of a traced run: the metrics' window counts every device
record once, the busy time is the union of their intervals, and the
diagnostic window's idle gaps are named by the innermost host event."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness, trace


def event(name, start, end, device=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_window_busy_is_the_union_of_device_records():
    prof = Prof([event("kernel_a", 0, 100), event("kernel_b", 50, 150),
                 event("Memcpy DtoH", 300, 400), event("aten::add", 0, 500, DeviceType.CPU),
                 event("Optimizer.step#Adam.step", 0, 400), event("range", 0, 400, annotation=True)])
    records, busy_s, ops = trace.reduce_window(prof)
    assert [r[2] for r in records] == ["kernel_a", "kernel_b", "Memcpy DtoH"]
    assert busy_s == pytest.approx(250e-6)
    assert ops[0] == ["kernel_a", pytest.approx(100e-6)] and len(ops) == 3
    t = trace.Trace(records=records, window_s=500e-6, busy_s=busy_s, units=2, work={},
                    kernels={"rollout": ["kernel_"]}, peaks=None)
    assert trace.idle_pct(t) == pytest.approx(50.0)
    assert trace.records_per_unit(t) == 1.5
    assert trace.role_seconds(t, "rollout") == pytest.approx(200e-6)
    assert trace.reduce_window(Prof([event("aten::add", 0, 5, DeviceType.CPU)]))[1:] == (0.0, [])


def test_idle_gaps_are_named_by_the_host_event():
    prof = Prof([event(trace.WINDOW, 0, 1000, DeviceType.CPU),
                 event("cudaStreamSynchronize", 90, 400, DeviceType.CPU),
                 event("kernel", 0, 100), event("kernel", 400, 900)])
    assert trace.idle_gaps(prof) == [["cudaStreamSynchronize", pytest.approx(300e-6)],
                                     ["host: between recorded ops", pytest.approx(100e-6)]]
    with pytest.raises(RuntimeError):
        trace.idle_gaps(Prof([event("kernel", 0, 1)]))


def test_a_knob_no_loop_reads_is_refused():
    mix = {**harness.load_json("traffic", "eval"), "clients": 4}
    with pytest.raises(ValueError, match="clients"):
        harness.check_traffic("eval_clients", mix)
    with pytest.raises(ValueError, match="no loop"):
        harness.check_traffic("serve", {"loop": "serve"})
    for name in ("train", "eval"):
        harness.check_traffic(name, harness.load_json("traffic", name))
