"""Seconds of set-up in which the program built its nets and drew their
weights on the CPU and moved them to the card (``build_system``,
``build_generator``, ``HPESystem``): the counter ``setup.init_weights_s``
of ``mmhand_torch.utils.trace``. The benchmark then loads weights of its
own."""


def read(r):
    try:
        from mmhand_torch.utils import trace
    except ImportError:  # a program without counters
        return None
    return trace.counters().get("setup.init_weights_s")
