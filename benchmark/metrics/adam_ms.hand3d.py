"""Device milliseconds of a profiled posenet step's Adam update: the CUDA-event
time of the program's ``adam`` spans (``make_hand3d_train_step``, in
``mmhand_torch.utils.trace``, which records while the profiler window is
open), summed per step and averaged over the window's steps."""

SPAN = "adam"


def read(r):
    try:
        from mmhand_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    per_step = {}
    for s in trace.spans():
        if s.name == SPAN:
            ms = s.device_ms
            if ms is not None:
                per_step[s.step] = per_step.get(s.step, 0.0) + ms
    return sum(per_step.values()) / len(per_step) if per_step else None
