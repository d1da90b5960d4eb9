"""On the card, at the cell's own size: the program's compared numbers
within the cell's limits, and the control's beyond them.  Skips without
a CUDA device (run ``python -m pytest benchmark/tests/test_bench_card.py``
on the H100)."""
import pytest
import torch

from benchmark.spec import Spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest "
                    "benchmark/tests/test_bench_card.py` on the H100")
    from benchmark import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.build_kernels()
    return torch.device("cuda:0")


def _against_control(card, workload):
    from benchmark import calibrate

    limits = Spec().limits(workload)
    (row,) = calibrate.readings(workload, [987654321], control=True, device=card)
    assert all(row["program"][k] <= lim for k, lim in limits.items()), row["program"]
    assert any(row["control"][k] > lim for k, lim in limits.items()), row["control"]


@pytest.mark.parametrize("workload", ["shiny_blender.fine_train", "dtu.coarse_train"])
def test_training_cell_against_its_control(card, workload):
    _against_control(card, workload)


def test_eval_cell_against_its_control(card):
    _against_control(card, "shiny_blender.eval_render")
