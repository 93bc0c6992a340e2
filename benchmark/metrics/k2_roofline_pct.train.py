"""K2's and K2b's share of their roofline: the bounds of every train-mode
BatchNorm site of a step (``roofline.BatchNormSites``, recorded on one step
in set-up) times the profiled steps, over the two kernels' device time in
the profiler window."""

KERNELS = ("bn_sums_kernel", "bn_sums_backward_kernel")


def read(r):
    if r.profile is None:
        return None
    seconds, _ = r.profile.kernel_s(*KERNELS)
    if not seconds:
        return None
    bound = (r.run.k2_s + r.run.k2b_s) * r.profile.steps
    return 100.0 * bound / seconds
