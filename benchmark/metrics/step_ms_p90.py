"""The 90th percentile of every step's time in the window: the gap between
consecutive step-end CUDA events, which the loop records and reads only at
the end.  A step whose device sat idle waiting on the host reads long."""

import statistics


def read(r):
    if len(r.step_ms) < 2:
        return None
    return statistics.quantiles(r.step_ms, n=10, method="inclusive")[8]
