"""Device ms of the fp32 VAE encode a step, from CUDA events around it."""

from benchmark import readers as R

LAYER = "Frozen encoders in the step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(run):
    return R.span_mean(run, "vae_encode")
