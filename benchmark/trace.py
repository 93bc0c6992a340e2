"""The benchmark's host spans and its reading of a torch.profiler window.

Spans are the benchmark's own, around each call into a layer of the
program; they are kept in memory as (name, start, end) on the host's
perf_counter.  While a profiler window is open they are also kept on the
wall clock, the clock of the profiler's device timestamps, so that an idle
gap of the device can be named by what the host was doing when it began.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import torch

# the spin kernels that open a window (torch.cuda._sleep)
PAD_KERNEL = "spin_kernel"
PAD_CALLS = 32


class Spans:
    """(name, start, end) of each span on the host's perf_counter, and
    while ``wall`` is on, (name, start, end) on the wall clock in ns, the
    clock of the profiler's device timestamps."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []
        self.wall: Optional[list] = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        w0 = time.time_ns() if self.wall is not None else 0
        yield
        self.records.append((name, t0, time.perf_counter()))
        if self.wall is not None:
            self.wall.append((w0, time.time_ns(), name))

    def seconds(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.records if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.records if n == name)


@dataclass
class Profile:
    """What a profiler window read: device time and launches by kernel
    name, the device's busy seconds (the union of its activities), the
    window's seconds on the host clock, and the idle gaps."""

    window_s: float
    steps: int
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)   # name -> [seconds, count]
    gaps: list = field(default_factory=list)      # (seconds, host span)

    def kernel_s(self, *names: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds one
        of ``names``."""
        s, n = 0.0, 0
        for key, (sec, count) in self.kernels.items():
            if any(name in key for name in names):
                s += sec
                n += count
        return s, n

    def top_ops(self, k: int = 10) -> list:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:k]
        return [[name[:160], sec] for name, (sec, _) in rows]

    def top_gaps(self, k: int = 10) -> list:
        return [[span, sec] for sec, span in sorted(self.gaps,
                                                    reverse=True)[:k]]


def pad_trace_start() -> None:
    """Launch and finish short spin kernels first: once a process has run a
    while, the H100's trace drops the first activities of a window."""
    for _ in range(PAD_CALLS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profile_window(step, n: int, spans: Spans, cuda: bool = True
                   ) -> Profile:
    """Run ``step()`` ``n`` times under torch.profiler's device tracing,
    between two synchronizations, and read the window.  Only the device's
    activities are traced, so that the host runs as it does untraced; the
    spans name the gaps.  Without ``cuda`` (the CPU tests) there is
    nothing to read."""
    from torch.profiler import ProfilerActivity, profile

    if not cuda:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        return Profile(window_s=time.perf_counter() - t0, steps=n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_trace_start()
        spans.wall = []
        try:
            w0, t0 = time.time_ns(), time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            window = (w0, time.time_ns())
        finally:
            wall, spans.wall = spans.wall, None
    return read_events(prof.profiler.kineto_results.events(), window_s, n,
                       window, wall)


def read_events(events, window_s: float, steps: int, window: tuple,
                wall: list) -> Profile:
    """Reduce kineto events to a Profile: the device's kernels, copies and
    sets inside ``window`` (wall-clock ns), their union, and each idle gap
    named by the innermost host span of ``wall`` open when it began (or
    the first begun during it)."""
    cuda = torch.autograd.DeviceType.CUDA
    device = [(e.start_ns(), e.end_ns(), e.name()) for e in events
              if e.device_type() == cuda and not e.is_user_annotation()
              and PAD_KERNEL not in e.name()]
    prof = Profile(window_s=window_s, steps=steps)
    lo, hi = window
    device = sorted((max(a, lo), min(b, hi), n) for a, b, n in device
                    if b > lo and a < hi)
    if not device:
        return prof
    kernels = defaultdict(lambda: [0.0, 0])
    busy, cursor, gaps = 0, lo, []
    for a, b, name in device:
        kernels[name][0] += (b - a) / 1e9
        kernels[name][1] += 1
        if a > cursor:
            gaps.append((cursor, a - cursor))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if hi > cursor:
        gaps.append((cursor, hi - cursor))
    named = []
    for g0, length in gaps:
        # the innermost span open when the gap began, else the first one
        # the host began during it
        open_ = [s for s in wall if s[0] <= g0 < s[1]]
        later = [s for s in wall if g0 < s[0] < g0 + length]
        label = (max(open_)[2] if open_ else
                 min(later)[2] if later else "outside spans")
        named.append((length / 1e9, label))
    # the window reported is the host clock's, which the union cannot pass
    prof.busy_s = min(busy / 1e9, window_s)
    prof.kernels = dict(kernels)
    prof.gaps = named
    return prof
