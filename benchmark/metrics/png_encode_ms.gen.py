"""Host milliseconds a profiled generation batch spends in ``write_png``:
the program's ``png.encode`` spans (``mmhand_torch.utils.trace``, which
records while the profiler window is open), summed per batch (the eval
step's number) and averaged over the window's batches. The rest of
``png_write_ms.gen`` is the fetch of the fakes and the directories."""

SPAN = "png.encode"


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
