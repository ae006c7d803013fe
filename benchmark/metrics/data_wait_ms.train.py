"""Host ms a window step waits for its batch: the host clock around each
next() of the prefetch loader's stream, mean over the window (the interval
StepTimer's time/data_s covers)."""

import statistics

LAYER = "Data"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "train_samples_per_s"


def read(run):
    waits = run["layer"]["waits"]
    return 1e3 * statistics.fmean(waits) if waits else None
