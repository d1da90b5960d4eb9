"""The frozen count functions at the cells' shapes against the
operation bounds the kernel table of PERF.md (section 6) gives."""
import pytest

from benchmark import counts
from benchmark.spec import Spec

BF16 = counts.PEAKS["bf16_flops"]


def _ms(flops):
    return flops / BF16 * 1e3


def test_head_dims_are_the_configured_widths():
    spec = Spec()
    fine = counts.head_dims(spec.config("shiny_blender")["fine_model"], True)
    assert fine["rgbnet"] == [106, 256, 256, 256, 256]
    assert fine["refnet"] == [307, 256, 256, 256, 3]
    coarse = counts.head_dims(spec.config("dtu")["coarse_model"], False)
    assert coarse["refnet"] == [102, 192, 192, 3]


def test_fine_head_products_match_b8_operation_bounds():
    m = 8192 * 128
    dims = counts.head_dims(Spec().config("shiny_blender")["fine_model"], True)
    assert _ms(counts.head_fwd(m, dims["rgbnet"], 0)[1]) == pytest.approx(0.4744, rel=1e-3)
    assert _ms(counts.head_fwd(m, dims["refnet"], 0)[1]) == pytest.approx(0.4462, rel=1e-3)


def test_dtu_coarse_head_matches_b3_operation_bound():
    m = 8192 * 288
    dims = counts.head_dims(Spec().config("dtu")["coarse_model"], False)["refnet"]
    fwd = counts.head_fwd(m, dims, 24)[1]
    assert _ms(fwd) == pytest.approx(0.2721, rel=1e-3)
    assert counts.head_bwd(m, dims, 24)[1] == 2 * fwd


@pytest.mark.parametrize("cell,groups", [
    ("shiny_blender.fine_train", {"serve B1", "accumulate B2", "serve B5", "accumulate B6"}),
    ("dtu.coarse_train", {"serve B1", "accumulate B2", "shade B3", "shade B4"}),
])
def test_kernel_bounds_name_the_cell_kernels(cell, groups):
    spec = Spec()
    wl = spec.workload(cell)
    tr = spec.traffic(wl["traffic"])
    model = spec.config(wl["config"])[f"{tr['stage']}_model"]
    b = counts.kernel_bounds(dict(n_rays=8192, model=model, stage=tr["stage"],
                                  world_size=(256, 256, 256), engine="sorted"))
    assert set(b) == groups
    assert all(v > 0 for v in b.values())


def test_fine_serve_bound_counts_positions_values_and_no_field():
    n_bytes, _ = counts.serve(1000, 16)
    assert n_bytes == 1000 * (12 + 64)
    acc_bytes, _ = counts.accumulate(1000, 16, 10)
    assert acc_bytes == n_bytes + 4 * 16 * 10


def _cell(name):
    spec = Spec()
    wl = spec.workload(name)
    tr = spec.traffic(wl["traffic"])
    return tr, spec.config(wl["config"])[f"{tr['stage']}_model"]


def test_kernel_bounds_merge_the_group_files(tmp_path):
    from benchmark import groups

    (tmp_path / "k0_densify.py").write_text(
        "FRAGMENTS = ('k0_densify',)\n\n\n"
        "def bound_s(cell):\n"
        "    return 1e-3 if cell['stage'] == 'fine' else None\n")
    loaded = groups.load(tmp_path)
    tr, model = _cell("shiny_blender.fine_train")
    cell = dict(n_rays=8192, model=model, stage="fine",
                world_size=(256, 256, 256), engine="sorted")
    frozen = counts.kernel_bounds(cell)
    assert counts.kernel_bounds(cell, loaded) == dict(frozen, k0_densify=1e-3)
    coarse = dict(cell, stage="coarse")
    assert "k0_densify" not in counts.kernel_bounds(coarse, loaded)
    lattice = dict(cell, engine="lattice")
    assert counts.kernel_bounds(lattice) == {}
    assert counts.kernel_bounds(lattice, loaded) == {"k0_densify": 1e-3}


@pytest.mark.parametrize("name,metric", [
    ("shiny_blender.fine_train", "train_mfu"),
    ("dtu.coarse_train", "coarse_mfu"),
    ("shiny_blender.eval_render", "eval_mfu"),
])
def test_mfu_is_the_capacity_count_times_live_over_capacity(name, metric):
    """The old reading counted every slot of the head's capacity (n_rays
    x shade_k rows a fine step or render chunk, x sample_k a coarse
    step); the new one counts the traced window's live rows a unit."""
    from benchmark.spec import load_reader

    tr, model = _cell(name)
    fine, train = tr["stage"] == "fine", tr["kind"] == "train"
    n = tr["chunk"] if not train else Spec().config(
        Spec().workload(name)["config"])[f"{tr['stage']}_train"]["N_rand"]
    capacity = n * (model["shade_k"] if fine else model["sample_k"])
    flops = sum(counts.macs(d) for d in counts.head_dims(model, fine).values())
    old_per_cap = (6.0 if train else 2.0) * capacity * flops
    units, chunks_per_unit, traced_units, live = 40, 79, 7, 7 * 31_337
    e2e = dict(units=units, chunks=units * chunks_per_unit, window_s=25.0)
    old = 100.0 * old_per_cap * (e2e["chunks"] if not train else units) \
        / (25.0 * BF16)
    rec = dict(kind=tr["kind"], e2e=e2e, units=traced_units,
               head_flops_per_row=counts.head_row_flops(model, fine, train),
               program={"counters": {"head_live_rows": live}})
    cap_per_unit = capacity * (chunks_per_unit if not train else 1)
    new = load_reader(Spec().bench_dir / "metrics" / f"{metric}.py")(rec)
    assert new == pytest.approx(old * (live / traced_units) / cap_per_unit,
                                rel=1e-12)
    rec["program"] = None
    assert load_reader(Spec().bench_dir / "metrics" / f"{metric}.py")(rec) is None
