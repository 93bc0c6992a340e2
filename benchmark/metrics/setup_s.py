"""Seconds from the start of the process to the first timed step: imports,
the data tree on a checkout's first run, the kernels' build on its first
run, the program's set-up, the benchmark's weights, the checked steps and
the warm-up."""


def read(r):
    return r.setup_s
