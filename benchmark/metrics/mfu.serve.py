"""The window's work at the card's peaks (bf16 989, fp32 67 TFLOP/s; FLOPs of the plain reference on the meta device) over the window's span."""

from benchmark import readers as R

LAYER = "Whole request"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "panels_per_s"


def read(run):
    return R.serve_mfu(run)
