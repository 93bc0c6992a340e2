"""Fakes written to disk in the measured window over the window's seconds."""


def read(r):
    return r.units / r.window_s
