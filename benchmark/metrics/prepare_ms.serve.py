"""Host ms a request spends in the program's serve.prepare span before its first launch: the characters' CLIP preprocessing, the bucket snap and the CPU latent draw; mean over the traced requests."""

from benchmark import spans as S

LAYER = "Serving"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "panels_per_s"


def read(run):
    return S.host_ms(S.program_spans(), "serve.prepare")
