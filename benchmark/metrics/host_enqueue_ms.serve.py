"""Host ms to issue one CFG denoise step: the mean host duration of the program's denoise.step span (UNet call, CFG combine, scheduler step) over the traced requests. Set beside unet_step_ms.serve, it says whether the host keeps ahead of the card."""

from benchmark import spans as S

LAYER = "Denoise loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panels_per_s"


def read(run):
    return S.host_ms(S.program_spans(), "denoise.step")
