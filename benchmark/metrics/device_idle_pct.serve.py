"""Share of the traced requests' span with no device operation running, from the profiler."""

from benchmark import readers as R

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "panels_per_s"


def read(run):
    return R.idle_pct(run)
