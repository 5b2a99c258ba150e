"""The device trace of a window: ``torch.profiler`` over the CUDA
activities only (kernels, copies, sets), read back as plain intervals, and
the benchmark's own host spans on the same clock (``time.time_ns``, the
clock the profiler stamps its events with)."""

from __future__ import annotations

import time
from collections import defaultdict


def now_ns() -> int:
    return time.time_ns()


class Spans:
    """Host spans the benchmark records around its calls into the program:
    (name, start_ns, end_ns, call index)."""

    def __init__(self):
        self.items = []

    def add(self, name: str, start: int, end: int, call: int) -> None:
        self.items.append((name, start, end, call))


class DeviceTrace:
    """Start with ``start()``, stop with ``stop()``; then ``events`` holds
    (name, kind, start_ns, end_ns) of every device activity, kind being
    "kernel", "memcpy_htod", "memcpy_dtoh", "memcpy" or "memset"."""

    def __init__(self, device="cuda"):
        self.events = []
        self._prof = None
        # On the CPU (the tests' dry runs) the host's own operators stand
        # in for the device's.
        self.cpu = str(device) == "cpu"

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[
            ProfilerActivity.CPU if self.cpu else ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType
        if not self.cpu:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        want = DeviceType.CPU if self.cpu else DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != want:
                continue
            name = e.name()
            start = e.start_ns()
            self.events.append((name, kind_of(name), start,
                                start + e.duration_ns()))
        self._prof = None


def kind_of(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "memcpy_htod"
    if name.startswith("Memcpy DtoH"):
        return "memcpy_dtoh"
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def busy_intervals(events, lo: int, hi: int):
    """The union of the events' intervals, clipped to [lo, hi], merged and
    sorted."""
    spans = sorted((max(s, lo), min(e, hi)) for _, _, s, e in events
                   if e > lo and s < hi)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def gaps(merged, lo: int, hi: int):
    """The idle stretches of [lo, hi] between merged busy intervals."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def host_label(spans, t: int) -> str:
    """The host span the benchmark was in at time t."""
    for name, s, e, _ in spans:
        if s <= t < e:
            return name
    return "harness"


def breakdown(events, spans, lo: int, hi: int, top: int = 10):
    """The device operations that took most time and the longest idle
    gaps, named by what the host was doing at their middle."""
    by_name = defaultdict(int)
    for name, _, s, e in events:
        if e > lo and s < hi:
            by_name[name[:160]] += min(e, hi) - max(s, lo)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(busy_intervals(events, lo, hi), lo, hi),
                  key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, t / 1e9] for n, t in ops],
            "idle_gaps": [[host_label(spans, (s + e) // 2), (e - s) / 1e9]
                          for s, e in idle]}
