"""The plain reference against the port's CPU path at a tiny size, and
the harness's comparison: a sound run passes the cell's limits; the
control and each fault the cell can have fail them."""
import pytest
import torch

from benchmark.spec import Spec
from benchmark.tests.tiny import tiny_cell

TRAIN = [("shiny_blender", "fine_train", "shiny_blender.fine_train"),
         ("dtu", "coarse_train", "dtu.coarse_train")]


def _correct(readings, workload):
    """The harness's rule: every number the cell's limits name within
    its limit."""
    return all(readings[k] <= lim for k, lim in Spec().limits(workload).items())


@pytest.mark.parametrize("config,traffic,workload", TRAIN)
def test_sound_run_is_correct(config, traffic, workload):
    driver, cell = tiny_cell(config, traffic)
    rec = driver.run(cell, 0.2)
    assert rec["e2e"]["failed"] == 0
    assert _correct(rec["readings"], workload), rec["readings"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("config,traffic,workload", TRAIN)
def test_faults_are_not_correct(config, traffic, workload, fault):
    driver, cell = tiny_cell(config, traffic)
    rec = driver.run(cell, 0.2, fault=fault)
    assert not _correct(rec["readings"], workload), rec["readings"]


@pytest.mark.parametrize("config,traffic,workload", TRAIN)
def test_control_is_not_correct(config, traffic, workload):
    driver, cell = tiny_cell(config, traffic)
    prog, check = driver.setup(cell)
    del prog
    ref = driver.reference_readings(cell, check)
    losses, grad, change = driver.reference_readings(cell, check, control=True)
    ctl = driver.compare(dict(losses=losses, grad=grad, change=change), ref)
    assert not _correct(ctl, workload), ctl


def test_eval_render_matches_and_a_changed_chunk_fails():
    driver, cell = tiny_cell("shiny_blender", "eval_render")
    rec = driver.run(cell, 0.1)
    assert rec["e2e"]["units"] >= 1 and rec["e2e"]["failed"] == 0
    assert _correct(rec["readings"], "shiny_blender.eval_render"), rec["readings"]
    driver, cell = tiny_cell("shiny_blender", "eval_render")
    rec = driver.run(cell, 0.1, fault="chunk")
    assert not _correct(rec["readings"], "shiny_blender.eval_render"), rec["readings"]


def test_eval_render_control_is_not_correct():
    driver, cell = tiny_cell("shiny_blender", "eval_render")
    rec = driver.run(cell, 0.1, control=True)
    assert _correct(rec["readings"], "shiny_blender.eval_render"), rec["readings"]
    assert not _correct(rec["control_gap"], "shiny_blender.eval_render"), rec["control_gap"]


def test_reference_scan_keeps_the_early_exit():
    from benchmark.reference import sdf_step as R
    alpha = torch.full((1, 12), 0.5)
    valid = torch.ones_like(alpha, dtype=torch.bool)
    w, last = R.scan(alpha, valid)
    # transmittance before sample i is 2^-i: sample 10 sees 2^-10 < 1e-3
    # and is dropped with every sample after it
    assert w[0, 9] == 2.0 ** -10 and torch.all(w[0, 10:] == 0.0)
    assert last[0] == 2.0 ** -10
