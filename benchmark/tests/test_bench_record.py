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
