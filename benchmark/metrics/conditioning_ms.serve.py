"""Device ms a request in the pipeline's encode_prompt and prepare_ip_image_embeds (both text encoders; CLIP-H, ViTMAE and the Resampler), from CUDA events around the two calls."""

from benchmark import readers as R

LAYER = "Conditioning"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panels_per_s"


def read(run):
    return R.span_mean(run, "conditioning", per="request")
