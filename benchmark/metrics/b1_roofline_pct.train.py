"""B1 (csrc/flash_attention.cu forward, replays included): least time of every traced launch from its shape over its kernels' profiler time."""

from benchmark import readers as R
from benchmark import yardstick as Y

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    return R.roofline(run, ["b1"], Y.flash_fwd_cost, "b1")
