"""A stretch of the window under torch.profiler, reduced to what the
per-layer metrics read.

The device's timeline is the union of the intervals of every device
activity in the trace (kernels, copies, fills; not the harness's spans,
which the profiler mirrors on the device's timeline): busy_s is its length, the
stretch's host wall time its window. A traced pass of the window records
the device's activities only, so that the host runs at its own pace: its
busy time, kernels and idle share are what the metrics read. A second
traced pass records the host's activities too, for the breakdown: an idle
gap is a stretch in which no device activity ran, put to the host activity
that covered its middle (the innermost host event: a span of the harness,
an ATen operator or a CUDA runtime call open at that instant).
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

NON_KERNEL = ("Memcpy", "Memset", "memcpy", "memset")
SPAN_PREFIX = "bench."          # the harness's host spans (record_function names)
NAME_CHARS = 160                # a breakdown entry's name is cut to this length


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return f() if f is not None else getattr(ev, f"{what}_us")() * 1000


def _union(intervals):
    """Sorted disjoint (start, end) of a list of intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def profile(fn, span: str, host: bool):
    """Run fn() under torch.profiler inside a host span named `span`,
    synchronised at both ends; with host, the host's activities are traced
    too (their recording slows the host: a pass traced so is only read for
    what the host had open in the device's idle gaps). Returns (fn's
    result, Trace)."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with _profile(activities=acts) as prof:
        with record_function(span):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return res, Trace(prof, span, wall)


class Trace:
    """The device intervals and host events of one profiled stretch."""

    def __init__(self, prof, span: str, wall_s: float):
        dev = torch.autograd.DeviceType.CUDA
        device, host = [], []
        by_name = defaultdict(lambda: [0, 0])
        self.kernels = 0
        self.window = None
        for ev in prof.profiler.kineto_results.events():
            s = _ns(ev, "start")
            e = s + _ns(ev, "duration")
            name = ev.name()
            if ev.device_type() == dev:
                if name.startswith(SPAN_PREFIX):      # a host span mirrored on the device's timeline
                    continue
                device.append((s, e))
                by_name[name][0] += e - s
                by_name[name][1] += 1
                if not name.startswith(NON_KERNEL):
                    self.kernels += 1
            else:
                host.append((s, e, name))
                if name == span:
                    self.window = (s, e)
        # without the host's events: the device's extent, and the host's clock for its length
        self.wall_s = None if self.window is not None else wall_s
        if self.window is None:
            self.window = (min(s for s, _e in device), max(e for _s, e in device)) if device else (0, 0)
        self.by_name = dict(by_name)
        w0, w1 = self.window
        self.busy = _union([(max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1])
        self.host = sorted(host)

    @property
    def window_s(self) -> float:
        return self.wall_s if self.wall_s is not None else (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def gaps(self) -> list:
        """(start, end) ns of every idle stretch of the window."""
        w0, w1 = self.window
        out, t = [], w0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if w1 > t:
            out.append((t, w1))
        return out

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took the most time and the idle time
        by what the host was doing, n of each, in seconds."""
        ops = sorted(((name[:NAME_CHARS], v[0] / 1e9) for name, v in self.by_name.items()),
                     key=lambda t: -t[1])[:n]
        idle = defaultdict(float)
        hosts = [h for h in self.host if (h[0], h[1]) != self.window]
        active, j = [], 0
        for s, e in self.gaps():                     # in time order: one sweep over the host events
            mid = (s + e) // 2
            while j < len(hosts) and hosts[j][0] <= mid:
                active.append(hosts[j])
                j += 1
            active = [h for h in active if h[1] > mid]
            names = [n for _s, _e, n in sorted(active)[-2:]]   # the two innermost open events
            idle[" > ".join(names) if names else "(no host event)"] += (e - s) / 1e9
        gaps = sorted(idle.items(), key=lambda t: -t[1])[:n]
        return dict(device_ops=[[k, v] for k, v in ops], idle_gaps=[[k, v] for k, v in gaps])
