"""Device ms a request in the pipeline's fp32 VAE decode (whole or tiled), from CUDA events around it."""

from benchmark import readers as R

LAYER = "Decode"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panels_per_s"


def read(run):
    return R.span_mean(run, "decode", per="request")
