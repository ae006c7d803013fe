"""Device ms a train step: the profiler's device operations summed over the
traced steps, over their count."""

LAYER = "Train step"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    layer = run["layer"]
    kernels = layer["trace"].kernels
    return sum(e - s for _, s, e in kernels) / 1e3 / layer["steps"] if kernels else None
