"""Milliseconds a batch of the window spends from the fakes' denormalize
through the batch's last PNG write (the benchmark's ``png_write`` span),
on average."""


def read(r):
    n = r.spans.count("png_write")
    return 1e3 * r.spans.seconds("png_write") / n if n else None
