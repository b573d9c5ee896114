"""The traced window: torch.profiler's device records reduced to what the
per-layer metrics read (busy time, records by name), the idle gaps of a
second, diagnostic window by what the host was doing, and the arithmetic
the metrics share.

The device records are the kernels, memcpy and memset the profiler saw on
the card. An annotation that spans the kernels it launched (the
optimizer's step) is left out, so nothing is counted twice.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

WINDOW = "portbench.window"


@dataclass
class Trace:
    """What a metric reader gets: the device records [(start_us, end_us,
    name)] of the window, its length on the host's clock (from a
    synchronised start to the synchronised end), the union of the records'
    intervals (busy_s), the units (steps or requests) it
    held, the work per unit by role (work/<config>.py), the configuration's
    kernel names by role and the card's peaks (None where unknown)."""

    records: list
    window_s: float
    busy_s: float
    units: int
    work: dict
    kernels: dict
    peaks: dict | None


def _union_gaps(intervals, lo, hi):
    """(busy seconds, idle gaps [(start, end)]) of the intervals in [lo, hi] (us)."""
    busy, reach, gaps = 0.0, lo, []
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if start > reach:
            gaps.append((reach, start))
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    if hi > reach:
        gaps.append((reach, hi))
    return busy / 1e6, gaps


def _host_during(cpu, starts, t):
    """The innermost host event that spans time t: the latest start <= t
    whose end passes t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):
        if cpu[j][1] >= t:
            return cpu[j][2]
    return "host: between recorded ops"


def device_records(prof):
    """The device records [(start_us, end_us, name)] of a profile: kernels,
    memcpy and memset, annotations left out."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer.")]


def _top(d):
    return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def reduce_window(prof):
    """(records, busy_s, device_ops) of a profile that spans the measured
    window alone, traced with device activity only, so that the host runs
    as it does untraced: every device record, the union of their intervals
    and the ten largest [name, seconds]."""
    records = device_records(prof)
    if not records:
        return records, 0.0, []
    busy_s, _ = _union_gaps([(s, e) for s, e, _ in records],
                            min(s for s, _, _ in records), max(e for _, e, _ in records))
    by_op = {}
    for start, end, name in records:
        by_op[name] = by_op.get(name, 0.0) + (end - start) / 1e6
    return records, busy_s, _top(by_op)


def idle_gaps(prof):
    """The ten largest idle gaps [name, seconds] of the device inside the
    record_function range WINDOW of a profile traced with host activity
    too, grouped by the innermost host event at each gap's middle. The host
    ops' recording slows the host, so these gaps are longer than untraced:
    they say where the host is, not how long."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError("the trace holds no window range")
    lo, hi = window[0].time_range.start, window[0].time_range.end
    records = [(s, e) for s, e, _ in device_records(prof) if e > lo and s < hi]
    cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CPU and e.name != WINDOW)
    _, gaps = _union_gaps(records, lo, hi)
    starts = [c[0] for c in cpu]
    by_host = {}
    for a, b in gaps:
        name = _host_during(cpu, starts, 0.5 * (a + b))
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    return _top(by_host)


def role_seconds(t: Trace, role: str):
    """Device seconds of the records whose name holds one of the role's
    kernel names; None if the configuration names no kernel for the role
    or no record matched."""
    names = t.kernels.get(role)
    if not names:
        return None
    spans = [(e - s) / 1e6 for s, e, n in t.records if any(k in n for k in names)]
    return sum(spans) if spans else None


def roofline_pct(t: Trace, role: str):
    """The role's least time at the card's peaks (the larger of operations
    over the FP32 rate and bytes over the memory rate, per launch, by the
    work count) over its kernels' device time, in %."""
    work, device_s = t.work.get(role), role_seconds(t, role)
    if work is None or device_s is None or t.peaks is None:
        return None
    bound = max(work["flops"] / t.peaks["fp32_flops_per_s"],
                work["bytes"] / t.peaks["bytes_per_s"])
    return 100.0 * bound * work["launches"] * t.units / device_s


def mfu_pct(t: Trace):
    """The counted FP32 operations of the window's units over the FP32 peak
    times the window, in %."""
    if t.peaks is None or t.units <= 0:
        return None
    flops = sum(w["flops"] * w["launches"] for w in t.work.values()) * t.units
    return 100.0 * flops / (t.peaks["fp32_flops_per_s"] * t.window_s)


def idle_pct(t: Trace):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None


def records_per_unit(t: Trace):
    return len(t.records) / t.units if t.units > 0 and t.records else None
