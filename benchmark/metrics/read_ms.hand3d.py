"""Host milliseconds of a profiled posenet step's record reads: the
program's ``hand3d.read`` spans (``Hand3dBinaryDataset.__getitem__``, in
``mmhand_torch.utils.trace``, which records while the profiler window is
open), summed per step and averaged over the window's steps."""

SPAN = "hand3d.read"


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
