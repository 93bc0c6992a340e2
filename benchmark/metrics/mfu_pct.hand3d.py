"""Model FLOPs of the window's posenet steps (``roofline.FlopCounter``,
counted on one step in set-up) over their time on the device clock, as a
share of the H100 SXM's dense TF32 peak (494.7 TFLOP/s): the convolutions
run in TF32, cuDNN's default, which the program leaves on.  The profiled
steps are left out."""

TF32_FLOPS = 494.7e12  # H100 SXM, dense TF32 on the tensor cores


def read(r):
    seconds = sum(r.step_ms) / 1e3
    if not seconds:
        return None
    return 100.0 * r.run.flops_per_step * r.steps / seconds / TF32_FLOPS
