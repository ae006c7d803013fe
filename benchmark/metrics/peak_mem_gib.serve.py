"""The allocator's peak, torch.cuda.max_memory_allocated, over the run up to the reference check, GiB."""

from benchmark import readers as R

LAYER = "Device"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "panels_per_s"


def read(run):
    return R.peak_gib(run)
