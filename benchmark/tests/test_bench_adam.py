"""The masked Adam kernel's group, bound and engagement metric on the
CPU: its kernel names fall to the "adam" group file and to no frozen
group, its bound on the fine cell is the fine grids' 28 B an element at
3.35 TB/s, and ``adam_fused.train`` reads the program's counters."""
import numpy as np
import pytest

from benchmark import groups, record, scene
from benchmark.drivers.train import world_size
from benchmark.spec import Spec

# the kernels as a trace names them (demangled, with their arguments)
KERNELS = [
    "masked_adam_step_vec4(float const*, float const*, float const*, "
    "float const*, float const*, float*, float*, float*, float const*, "
    "float const*, long long, Consts)",
    "masked_adam_step_flat(float const*, float const*, float const*, "
    "float const*, float const*, float*, float*, float*, float const*, "
    "float const*, long long, Consts)",
    "masked_adam_step_tiled(float const*, float const*, float const*, "
    "float const*, float const*, float*, float*, float*, float const*, "
    "float const*, long long, int, int, Strides, Consts)",
]


def _adam():
    return next(g for g in groups.load() if g.name == "adam")


def _train_cell(config, stage):
    cfg = Spec().config(config)
    model = cfg[f"{stage}_model"]
    box = np.asarray(cfg["box_stated"][stage], np.float32)
    ws, _ = world_size(model, box, scene.final_rung_voxels(cfg, stage))
    return dict(n_rays=int(cfg[f"{stage}_train"]["N_rand"]), model=model,
                stage=stage, world_size=ws, engine=model.get("engine"))


@pytest.mark.parametrize("kernel", KERNELS)
def test_the_kernels_fall_to_the_adam_group_alone(kernel):
    assert record.bucket(kernel) == "other"   # no frozen group takes them
    assert record.bucket(kernel, groups.load()) == "adam"


def test_the_fine_cell_bound_is_the_fine_grids_at_28_bytes():
    cell = _train_cell("shiny_blender", "fine")
    assert tuple(cell["world_size"]) == (258, 257, 252)
    want = 16_709_112 * 13 * 28 / 3.35e12
    assert _adam().bound_s(cell) == pytest.approx(1.816e-3, rel=1e-3)
    assert _adam().bound_s(cell) == pytest.approx(want, rel=1e-12)


def test_the_tensorf_cell_bound_counts_the_factors():
    cell = _train_cell("shiny_blender_tensorf", "fine")
    cell["model"] = dict(cell["model"], k0_dim=0)   # as `count_cell` gives it
    elems = 16_709_112 + 48 * (258 * 257 + 258 * 252 + 257 * 252 + 767)
    assert _adam().bound_s(cell) == pytest.approx(elems * 28 / 3.35e12,
                                                  rel=1e-12)


def test_the_eval_cell_has_no_adam_bound():
    cfg = Spec().config("shiny_blender")
    cell = dict(n_rays=8192, model=cfg["fine_model"], stage="fine",
                world_size=(258, 257, 252), engine="lattice")
    assert _adam().bound_s(cell) is None


def _record(counters, kind="train"):
    return {"kind": kind, "units": 10,
            "program": None if counters is None else {"counters": counters}}


def test_adam_fused_reads_the_counters():
    read = Spec().reader("adam_fused.train")
    assert read(_record({"adam_elems": 400, "adam_fused_elems": 400})) == 100.0
    assert read(_record({"adam_elems": 400, "adam_fused_elems": 100})) == 25.0
    assert read(_record({"adam_elems": 400})) == 0.0
    assert read(_record({"head_rows": 5})) is None   # the parent's program
    assert read(_record(None)) is None
    assert read(_record({"adam_elems": 4, "adam_fused_elems": 4},
                        kind="eval")) is None


def test_adam_roofline_reads_the_group_against_its_bound():
    read = Spec().reader("adam_roofline")
    rec = {"units": 10, "bounds": {"adam": 1.8e-3}, "groups": {"adam": 0.02}}
    assert read(rec) == pytest.approx(90.0)
    assert read(dict(rec, groups={"elementwise": 0.1})) is None
