"""B2 with B4 (csrc/flash_attention.cu backward, dQ then dK and dV): least time of each traced backward from its shape over both kernels' profiler time."""

from benchmark import readers as R
from benchmark import yardstick as Y

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    return R.roofline(run, ["b2", "b4"], Y.flash_bwd_cost, "b2")
