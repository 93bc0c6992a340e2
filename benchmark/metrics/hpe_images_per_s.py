"""HPE images stepped in the measured window over the window's seconds, which
end in a synchronization."""


def read(r):
    return r.units / r.window_s
