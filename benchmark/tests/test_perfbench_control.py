"""The control on the card: each cell's lower-precision path (serving on the
program's weight-only int8 UNet with TF32 in the VAE; training with bf16
trainables) must come out not correct, at the cell's own size and limits.
A short window: the control's readings need no long one. Marked ``gpu``:
skips without a card; run on the card with
``python -m pytest --noconftest -p no:cacheprovider benchmark/tests -m gpu``."""

import pytest

CELLS = ["serve_candidates_1024x4", "train_stage2_1024_b8"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark import calibrate, run as R

    limits = R.cell_files(R.load_bench(), workload)[2]["limits"]
    for rec in calibrate.readings(workload, [2 ** 33 + 101], ["control"], 4):
        assert any(rec["check"][k] > limits[k] for k in limits), rec
