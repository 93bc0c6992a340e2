"""Host milliseconds of a profiled GAN step's call
(``TrainStep.__call__``, the program's ``step`` span
(``mmhand_torch.utils.trace``, which records while the profiler window is
open)): the time the host takes to enqueue a step, averaged over the
window's steps."""

SPAN = "step"


def read(r):
    try:
        from mmhand_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    per_step = {}
    for s in trace.spans():
        if s.name == SPAN:
            ms = s.host_ms
            if ms is not None:
                per_step[s.step] = per_step.get(s.step, 0.0) + ms
    return sum(per_step.values()) / len(per_step) if per_step else None
