"""Host milliseconds of a profiled posenet step's call (the ``train_step``
of ``make_hand3d_train_step``, the program's ``step`` span
(``mmhand_torch.utils.trace``, which records while the profiler window is
open)), averaged over the window's steps."""

SPAN = "step"


def read(r):
    try:
        from mmhand_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    per_step = {}
    for s in trace.spans():
        if s.name == SPAN:
            per_step[s.step] = per_step.get(s.step, 0.0) + s.host_ms
    return sum(per_step.values()) / len(per_step) if per_step else None
