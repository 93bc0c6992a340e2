"""Share of the profiler window in which no activity ran on the device."""


def read(r):
    if r.profile is None or not r.profile.kernels:
        return None
    return 100.0 * (1.0 - r.profile.busy_s / r.profile.window_s)
