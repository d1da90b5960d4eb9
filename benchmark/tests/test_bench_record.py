"""Rate, tail, busy and idle arithmetic on synthetic event lists."""
import pytest

from benchmark import record


def test_percentile_interpolates_like_numpy():
    v = [10.0, 20.0, 30.0, 40.0, 50.0]
    assert record.percentile(v, 50) == 30.0
    assert record.percentile(v, 90) == pytest.approx(46.0)
    assert record.percentile([7.0], 90) == 7.0


def test_rate_is_work_over_the_whole_window():
    assert record.rate(8192 * 10, 2.0) == 40960.0
    with pytest.raises(ValueError):
        record.rate(1, 0.0)


def test_idle_share_of_a_window_with_a_stall():
    # kernels back to back for 0.8 s, then a 1.0 s stall, then 0.2 s busy
    kernels = [(0.0, 0.4), (0.3, 0.8), (1.8, 2.0)]
    assert record.busy_within(kernels, 0.0, 2.0) == pytest.approx(1.0)
    assert record.idle_share(kernels, 0.0, 2.0) == pytest.approx(0.5)
    assert record.gaps(kernels, 0.0, 2.0) == [(0.8, 1.8)]


def test_tail_of_step_intervals_sees_the_stall():
    steps = [220.0] * 99 + [1220.0]  # one step waits a second
    assert record.percentile(steps, 90) == 220.0
    assert record.percentile(steps, 99.5) > 220.0


def test_gaps_are_named_by_the_innermost_host_span():
    device = [(0.0, 1.0), (1.5, 2.0), (2.1, 3.0)]
    spans = [("step", 0.9, 1.6), ("draw", 1.95, 2.15), ("window", 0.0, 3.0)]
    named = record.named_gaps(device, spans, 0.0, 3.0)
    assert named[0] == ["step", pytest.approx(0.5)]
    assert named[1] == ["draw", pytest.approx(0.1)]


def test_buckets_match_the_kernel_names():
    assert record.bucket("window_gather_tiles<16>") == "serve B1"
    assert record.bucket("void at::native::vectorized_elementwise_kernel") == "elementwise"
    assert record.bucket("sm90_xmma_gemm_f32f32") == "matmul"
    assert record.bucket("unknown") == "other"
    groups = record.group_seconds([("fused_shade_fwd", 0.0, 0.5),
                                   ("fused_shade_dw", 1.0, 1.25)])
    assert groups == {"shade B3": 0.5, "shade B4": 0.25}


def test_host_spans_are_placed_on_the_trace_clock_by_the_anchor():
    from benchmark import trace as T

    tr = T.Traced()
    tr.anchor = 100.0
    tr.host_spans = [("draw", 100.001, 100.002), ("window", 100.001, 100.010)]
    # the trace's clock runs 5,000 s ahead; the synchronize at the end of
    # the window is a second candidate and must not be taken
    sync = {"cat": "cuda_runtime", "name": T.ANCHOR, "dur": 5}
    events = [dict(sync, ts=5100.0e6), dict(sync, ts=5100.009e6),
              {"cat": "kernel", "name": "k", "ts": 5100.0015e6, "dur": 8000},
              {"cat": "gpu_memcpy", "name": "m", "ts": 5100.0012e6, "dur": 100}]
    tr.load(events)
    assert tr.anchored
    assert tr.window == pytest.approx((5100.001, 5100.010))
    assert tr.spans == [("draw", pytest.approx(5100.001), pytest.approx(5100.002))]
    assert [k[0] for k in tr.kernels] == ["k"] and len(tr.device) == 2


def test_a_trace_without_the_anchor_takes_the_device_span():
    from benchmark import trace as T

    tr = T.Traced().load([{"cat": "kernel", "name": "k", "ts": 2e6, "dur": 5e5},
                          {"cat": "kernel", "name": "k", "ts": 3e6, "dur": 5e5}])
    assert not tr.anchored and tr.window == (2.0, 3.5) and tr.spans == []


BUCKETS_AT_PR_17 = (
    ("accumulate B7", ("rowmajor_",)),
    ("serve B5", ("tap_serve_samples",)),
    ("accumulate B6", ("tap_tile_accumulate", "tap_block_sums",
                       "tap_run_totals")),
    ("serve B1", ("window_gather_tiles",)),
    ("accumulate B2", ("cm_tile_accumulate", "cm_block_sums",
                       "cm_run_totals")),
    ("shade B3", ("fused_shade_fwd",)),
    ("shade B4", ("fused_shade_bwd", "fused_shade_dw",
                  "shade_reduce_partials")),
    ("matmul", ("gemm", "Gemm", "cutlass")),
    ("sort", ("sort", "radix", "Sort")),
    ("gather/scatter", ("index", "gather", "scatter", "Index")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized")),
)
KERNELS = [("window_gather_tiles<16>", 0.0, 1.0), ("cm_block_sums", 1.0, 1.5),
           ("void at::native::vectorized_elementwise_kernel", 2.0, 2.25),
           ("sm90_xmma_gemm_f32f32", 3.0, 3.5), ("k0_densify_fwd", 4.0, 4.75),
           ("k0_densify_index_bwd", 5.0, 5.5), ("unknown", 6.0, 6.125)]


def _group_file(directory, name, fragments, bound="None"):
    (directory / f"{name}.py").write_text(
        f"FRAGMENTS = {tuple(fragments)!r}\n\n\n"
        f"def bound_s(cell):\n    return {bound}\n")


def test_the_frozen_buckets_are_those_of_pr_17():
    assert record.BUCKETS == BUCKETS_AT_PR_17


def test_without_group_files_the_groups_are_the_frozen_ones():
    from benchmark import groups

    def frozen(kernel):
        return next((b for b, frags in BUCKETS_AT_PR_17
                     if any(f in kernel for f in frags)), "other")
    want = {}
    for name, s, e in KERNELS:
        want[frozen(name)] = want.get(frozen(name), 0.0) + (e - s)
    assert groups.load() == ()
    assert record.group_seconds(KERNELS, groups.load()) == want
    assert record.group_seconds(KERNELS) == want


def test_a_group_file_takes_only_names_that_would_be_other(tmp_path):
    from benchmark import groups

    # "k0_densify" also matches the index kernel, which "gather/scatter"
    # keeps; "cm_block" matches a B2 kernel, which B2 keeps
    _group_file(tmp_path, "k0_densify", ["k0_densify", "cm_block"])
    got = record.group_seconds(KERNELS, groups.load(tmp_path))
    assert got["k0_densify"] == 0.75
    assert got["gather/scatter"] == 0.5
    assert got["accumulate B2"] == 0.5
    assert got["other"] == 0.125
    assert record.bucket("unknown", groups.load(tmp_path)) == "other"


def test_two_group_files_that_match_one_name_are_an_error(tmp_path):
    from benchmark import groups

    _group_file(tmp_path, "densify", ["densify"])
    _group_file(tmp_path, "k0_densify", ["k0_"])
    loaded = groups.load(tmp_path)
    assert [g.name for g in loaded] == ["densify", "k0_densify"]
    with pytest.raises(ValueError, match="densify"):
        record.group_seconds(KERNELS, loaded)


@pytest.mark.parametrize("name", ["other", "elementwise", "matmul"])
def test_a_group_file_may_not_take_a_frozen_name(tmp_path, name):
    from benchmark import groups

    _group_file(tmp_path, name, ["unknown"])
    with pytest.raises(ValueError, match="frozen"):
        groups.load(tmp_path)
