"""B5 (csrc/dual_cross_attention.cu): least time of every traced launch from its shape over its kernels' profiler time."""

from benchmark import readers as R
from benchmark import yardstick as Y

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "panels_per_s"


def read(run):
    return R.roofline(run, ["b5"], Y.dual_cost, "b5")
