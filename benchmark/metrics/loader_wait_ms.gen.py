"""Milliseconds a step of the window waits in the host loader's iterator
(the benchmark's ``loader`` span around ``next()``), on average."""


def read(r):
    n = r.spans.count("loader")
    return 1e3 * r.spans.seconds("loader") / n if n else None
