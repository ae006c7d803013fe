"""Share of the traced steps' span with no device operation running, from the profiler."""

from benchmark import readers as R

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    return R.idle_pct(run)
