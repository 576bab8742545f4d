"""On a card: the control (the configuration's lower precision, the
program's own one-pass TF32 path, in the program's place) fails the output
check, and the program at its stated precision passes it, at sizes a test
run holds (fewer draws, a smaller batch than the cells time)."""

import pytest

from benchmark import harness

CASES = {"lstm_large.rank": {"draws": 100, "conditions": 20},
         "lstm_wide_dual.amortized": {"draws": 2000},
         "lstm_large.train": {"batch": 512}}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(CASES))
def test_control_fails_and_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(workload)
    cell.mix.update(CASES[workload])
    device = torch.device("cuda", 0)
    for seed in (11, 12, 13):
        control = harness.run_cell(cell, seed, 0.5, False, device, control=True)
        assert not control["correct"], control["checks"]
        assert harness.run_cell(cell, seed, 0.5, False, device)["correct"]
