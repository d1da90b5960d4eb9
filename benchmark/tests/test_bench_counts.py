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
