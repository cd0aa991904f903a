"""mfu.<kind> (``mfu.eval``, ``mfu.serve``): the model's matrix-product
FLOPs over the measured window (``portbench.flops``: forward only, counted
from the configuration's widths and the padded shapes each step runs at),
as a share of one H100's dense bf16 peak (989 TFLOP/s) for the window's
length."""

PEAK_FLOPS = 989e12


def read(run):
    w = run.window
    return 100.0 * w["flops"] / (w["window_s"] * PEAK_FLOPS)
