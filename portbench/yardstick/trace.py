"""The traced window: one ``torch.profiler`` session over the whole measured
window, kept in memory, reduced here to what the per-layer metrics read.

A session started after others on the H100 (torch 2.11) loses the device
records of its first launches; so it opens with ``PAD`` launches of torch's
empty spin kernel (``torch.cuda._sleep(0)``), whose records are left out.

While the session runs, the program's kernel wrappers launch inside profiler
ranges named ``launch:<wrapper>`` (the program's ``autotune.PROFILE_RANGES``).
The profiler mirrors each range on the device's timeline, spanning the
kernels launched inside it; a wrapper's device time is the sum of the device
operations lying within its ranges there.
"""
from __future__ import annotations

import bisect
import time

PAD = 1024
SPIN = "spin_kernel"
RANGE = "launch:"


def _union_ns(spans: list[tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Window:
    """Start with ``start()`` just before the window's first job; ``stop()``
    just after its last has finished, then ``summary()``."""

    def __init__(self, torch, autotune):
        self.torch, self.at = torch, autotune
        self.prof = None
        self.seconds = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        for _ in range(PAD):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        self.at.PROFILE_RANGES = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.at.PROFILE_RANGES = False
        self.prof.stop()

    def summary(self) -> dict:
        """{"ops": [(start_ns, end_ns, name)] of the device, sorted;
        "ranges": {wrapper: [device ns inside its ranges, ranges]};
        "host": [(start_ns, end_ns, name)] of the host's operations;
        "busy_s", "window_s", "device_s"}."""
        from torch.autograd import DeviceType

        ops, ranges, host = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            span = (e.start_ns(), e.end_ns())
            if e.device_type() == DeviceType.CUDA:
                if SPIN in name:
                    continue
                if name.startswith(RANGE):
                    ranges.append((*span, name[len(RANGE):]))
                else:
                    ops.append((*span, name))
            elif span[1] > span[0]:
                host.append((*span, name))
        self.prof = None
        ops.sort()
        host.sort()
        starts = [a for a, _, _ in ops]
        wrappers: dict[str, list] = {}
        for a, b, name in ranges:
            i, ns = bisect.bisect_left(starts, a), 0
            while i < len(ops) and ops[i][0] <= b:
                if ops[i][1] <= b:
                    ns += ops[i][1] - ops[i][0]
                i += 1
            acc = wrappers.setdefault(name, [0, 0])
            acc[0] += ns
            acc[1] += 1
        return {"ops": ops, "ranges": wrappers, "host": host,
                "busy_s": _union_ns([(a, b) for a, b, _ in ops]) / 1e9,
                "device_s": sum(b - a for a, b, _ in ops) / 1e9,
                "window_s": self.seconds}


def top_ops(summary: dict, n: int = 10) -> list:
    """The device operations that took most time: [[name, seconds]]."""
    by: dict[str, int] = {}
    for a, b, name in summary["ops"]:
        by[name] = by.get(name, 0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]


def idle_gaps(summary: dict, n: int = 10) -> list:
    """The longest gaps between device operations, each named by the
    innermost host operation running at its middle: [[name, seconds]]."""
    ops, host = summary["ops"], summary["host"]
    gaps, end = [], None
    for a, b, _ in ops:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    hstarts = [a for a, _, _ in host]
    longest = max((b - a for a, b, _ in host), default=0)
    out = []
    for ns, a, b in gaps[:n]:
        mid = (a + b) // 2
        i = bisect.bisect_right(hstarts, mid)
        best = None
        for j in range(i - 1, -1, -1):
            ha, hb, name = host[j]
            if hb >= mid and (best is None or hb - ha < best[0]):
                best = (hb - ha, name)
            if mid - ha > longest:
                break
        out.append([(best[1] if best else "no host operation")[:120], ns / 1e9])
    return out
