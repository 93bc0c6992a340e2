"""Milliseconds ``HPEMixDataset.batch`` takes to read a batch's items (PNG
decodes and labels): the program's ``hpe.decode`` spans
(``mmhand_torch.utils.trace``, which records while the profiler window is
open), averaged over the window's batches."""

SPAN = "hpe.decode"


def read(r):
    try:
        from mmhand_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    ms = [s.host_ms for s in trace.spans() if s.name == SPAN]
    return sum(ms) / len(ms) if ms else None
