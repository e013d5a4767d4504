"""Device timing: the reading of a torch.profiler trace into busy time,
kernels and idle gaps, and a call's device time from such a trace."""

from __future__ import annotations

import heapq
from collections import defaultdict


def device_s(fn, arg, calls: int = 100, warm: int = 10) -> float | None:
    """Device seconds of one ``fn(arg)``: ``warm`` calls untraced, then
    ``calls`` calls under torch.profiler, the union of their device
    operations' intervals over the calls.  None where the trace holds no
    device operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn(arg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(arg)
        torch.cuda.synchronize()
    tr = Trace(prof, 0.0)
    return tr.busy_s / calls if tr.device else None


def union_ns(intervals: list) -> tuple:
    """The merged (start, end) intervals of ``intervals`` and their total
    length: time in which at least one operation ran."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged, sum(e - s for s, e in merged)


class Trace:
    """A profiled window read from the profiler's raw events (building
    ``key_averages()`` costs about a millisecond an event)."""

    NOT_KERNELS = ("Memcpy", "Memset")

    def __init__(self, prof, wall_s: float):
        from torch.autograd import DeviceType

        self.wall_s = wall_s
        self.device = []  # (start_ns, end_ns, name)
        self.host = []
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            row = (start, start + dur, e.name())
            if e.device_type() == DeviceType.CUDA:
                self.device.append(row)
            elif dur > 0:
                self.host.append(row)
        self.merged, busy = union_ns([(s, e) for s, e, _ in self.device])
        self.busy_s = busy / 1e9

    @property
    def kernels(self) -> int:
        return sum(1 for _, _, n in self.device
                   if not n.startswith(self.NOT_KERNELS))

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        total = defaultdict(int)
        for s, e, name in self.device:
            total[name[:160]] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """[host activity, seconds] of the device's idle gaps, each gap put
        to the innermost host event that spans its middle ("host" where
        none does), the longest totals first."""
        host = sorted(self.host)
        total = defaultdict(int)
        # the host events started so far, the latest start on top: with
        # nested events the latest-started one still running is the
        # innermost
        active, at = [], 0
        for (_, a), (b, _) in zip(self.merged, self.merged[1:]):
            mid = (a + b) // 2
            while at < len(host) and host[at][0] <= mid:
                s, e, hname = host[at]
                heapq.heappush(active, (-s, e, hname))
                at += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            name = active[0][2] if active else "host"
            total[name[:160]] += b - a
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]
