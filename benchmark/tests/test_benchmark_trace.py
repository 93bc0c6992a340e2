"""The profiler window's reading, on made-up device events: the union of
the activities, the idle gaps named by the host span open when each began,
and the spin kernels and annotations left out."""

from __future__ import annotations

import torch

from benchmark import trace

CUDA = torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, a, b, annotation=False):
        self._n, self._a, self._b, self._ann = name, a, b, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return CUDA

    def is_user_annotation(self):
        return self._ann


def test_read_events():
    events = [Event("spin_kernel", 0, 50), Event("k1", 100, 300),
              Event("k2", 250, 400), Event("k1", 600, 700),
              Event("bench.step", 100, 900, annotation=True)]
    wall = [(90, 400, "step"), (400, 650, "loader"), (650, 1000, "step")]
    prof = trace.read_events(events, 1e-6, 2, (50, 1000), wall)
    assert prof.busy_s == 400e-9          # [100, 400] and [600, 700]
    assert prof.kernels == {"k1": [300e-9, 2], "k2": [150e-9, 1]}
    # the first gap began before any span: named by the span begun in it
    assert sorted(prof.gaps) == [(50e-9, "step"), (200e-9, "loader"),
                                 (300e-9, "step")]
    assert prof.kernel_s("k1") == (300e-9, 2)
    assert prof.top_gaps(1) == [["step", 300e-9]]
