"""Device ms of one UNet call on the CFG batch, from CUDA events around each call, mean over the traced requests."""

from benchmark import readers as R

LAYER = "Denoise loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panels_per_s"


def read(run):
    return R.span_mean(run, "unet")
