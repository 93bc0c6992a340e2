"""K1's share of its roofline: its least time on the H100 (the frozen
``roofline.k1_bound_s`` of the run's batch) times its launches in the
profiler window, over their device time there."""

KERNEL = "gaussian_heatmaps_kernel"


def read(r):
    if r.profile is None:
        return None
    seconds, launches = r.profile.kernel_s(KERNEL)
    if not seconds:
        return None
    return 100.0 * r.run.k1_s * launches / seconds
