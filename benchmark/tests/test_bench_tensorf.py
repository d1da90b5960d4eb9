"""The TensoRF cell at a tiny size on the CPU: the program's fine step
with a factored k0 against the plain reference that densifies it
(``reference/tensorf.py``).  A sound run passes the cell's limits; the
control and each fault the cell can have fail them."""
import pytest

from benchmark.spec import Spec
from benchmark.tests.tiny import tiny_cell

CELL = ("shiny_blender_tensorf", "fine_train_tensorf")
WORKLOAD = "shiny_blender_tensorf.fine_train_tensorf"


def _correct(readings):
    return all(readings[k] <= lim for k, lim in Spec().limits(WORKLOAD).items())


def test_the_cell_runs_the_factored_k0():
    driver, cell = tiny_cell(*CELL)
    assert driver.__name__ == "benchmark.drivers.train_tensorf"
    k0 = cell.state()["k0"]
    r = cell.model["tensorf_n_comp"]
    assert k0["xy_plane"].shape == (*cell.ws[:2], r)
    assert k0["f_vec"].shape == (3 * r, cell.model["k0_dim"])
    assert cell.count_cell()["model"]["k0_dim"] == 0   # [sdf | grad] served


def test_sound_run_is_correct():
    driver, cell = tiny_cell(*CELL)
    rec = driver.run(cell, 0.2)
    assert rec["e2e"]["units"] >= 1 and rec["e2e"]["failed"] == 0
    assert _correct(rec["readings"]), rec["readings"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_faults_are_not_correct(fault):
    driver, cell = tiny_cell(*CELL)
    rec = driver.run(cell, 0.2, fault=fault)
    assert not _correct(rec["readings"]), rec["readings"]


def test_control_is_not_correct():
    driver, cell = tiny_cell(*CELL)
    prog, check = driver.setup(cell)
    del prog
    ref = driver.reference_readings(cell, check)
    losses, grad, change = driver.reference_readings(cell, check, control=True)
    ctl = driver.compare(dict(losses=losses, grad=grad, change=change), ref)
    assert not _correct(ctl), ctl
