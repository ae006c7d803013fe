"""The window's steps at the card's peaks (forward, the backward the trainables need, no remat replay; FLOPs of the plain reference on the meta device) over the window's span."""

from benchmark import readers as R

LAYER = "Train step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_samples_per_s"


def read(run):
    return R.train_mfu(run)
