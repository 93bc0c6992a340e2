"""Device milliseconds of a profiled generation batch's forward: the CUDA-
event time of the program's ``gen.forward`` span (``make_eval_step``;
``mmhand_torch.utils.trace``, which records while the profiler window is
open), averaged over the window's batches."""

SPAN = "gen.forward"


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
