"""Milliseconds a loader worker takes to read one GAN batch: the program's
``loader.assemble`` spans on the ``HostLoader`` threads
(``mmhand_torch.utils.trace``, which records while the profiler window is
open), averaged over the batches read in the window."""

SPAN = "loader.assemble"


def read(r):
    try:
        from mmhand_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    ms = [s.host_ms for s in trace.spans() if s.name == SPAN]
    return sum(ms) / len(ms) if ms else None
