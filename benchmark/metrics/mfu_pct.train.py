"""Model FLOPs of the window's steps (``roofline.FlopCounter``, counted on
one step in set-up) over their time on the device clock, as a share of the
H100's dense bf16 peak; the profiled steps are left out."""

from benchmark.roofline import BF16_FLOPS


def read(r):
    seconds = sum(r.step_ms) / 1e3
    if not seconds:
        return None
    return 100.0 * r.run.flops_per_step * r.steps / seconds / BF16_FLOPS
