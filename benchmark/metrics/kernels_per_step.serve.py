"""Device operations a denoise step: every operation the profiler saw in the
traced requests over their UNet calls (conditioning and decode included,
one request's worth over 30 steps). Host launch overhead scales with it."""

LAYER = "Denoise loop"
UNIT = "kernels"
SOURCE = "device_trace"
MOVES = "panels_per_s"


def read(run):
    layer = run["layer"]
    calls = len(layer["spans"].get("unet", []))
    kernels = len(layer["trace"].kernels)
    return kernels / calls if calls and kernels else None
