"""Host ms a batch spends in the program's data.put span on the prefetch loader's producer thread (pin, then the non-blocking copy to the card), mean over the batches put while the steps were traced."""

from benchmark import spans as S

LAYER = "Data"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(run):
    return S.host_ms(S.program_spans(), "data.put")
