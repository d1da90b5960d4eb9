"""Device time credited to the span that launched it, the synchronizing
calls, ``run_record``'s ``program`` entry and the metric files that read
it, on a hand-written Chrome trace: kernels and copies with their
correlated launches, the anchor synchronize, the benchmark's spans and
the program's."""
import pytest

from benchmark import harness, program, record
from benchmark import trace as T
from benchmark.spec import Spec

OFF = 5000.0          # the trace's clock less perf_counter
WINDOW = (100.001, 100.100)
BENCH = [("window", *WINDOW), ("draw", 100.0010, 100.0020),
         ("step", 100.0020, 100.0500)]
# name, id, parent, tid, start, end (perf_counter); the second shade ran on
# autograd's worker thread, under backward
PROGRAM = [("train_step", 0, None, 1, 100.0030, 100.0480),
           ("forward", 1, 0, 1, 100.0040, 100.0200),
           ("shade", 2, 1, 1, 100.0100, 100.0160),
           ("backward", 3, 0, 1, 100.0210, 100.0400),
           ("shade", 4, 3, 2, 100.0250, 100.0300),
           ("adam", 5, 0, 1, 100.0410, 100.0470)]


def _ev(cat, name, t, dur=1e-6, corr=None, tid=1):
    e = {"cat": cat, "name": name, "ts": (OFF + t) * 1e6, "dur": dur * 1e6,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    rt, k = "cuda_runtime", "kernel"
    return [
        _ev(rt, T.ANCHOR, 100.0000),
        # draw: 1 ms
        _ev(rt, "cudaLaunchKernel", 100.0015, corr=1),
        _ev(k, "gather", 100.0016, 1e-3, corr=1),
        # forward: 2 ms, a synchronize and a device-to-host copy
        _ev(rt, "cudaLaunchKernel", 100.0050, corr=2),
        _ev(k, "vectorized_elementwise", 100.0050, 2e-3, corr=2),
        _ev(rt, "cudaDeviceSynchronize", 100.0075),
        _ev(rt, "cudaMemcpy", 100.0080, corr=10),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 100.0080, 1e-4,
            corr=10),
        # forward/shade: 3 ms
        _ev(rt, "cudaLaunchKernel", 100.0120, corr=3),
        _ev(k, "gemm", 100.0120, 3e-3, corr=3),
        # backward: 5 ms, then its recompute's shade (a driver launch from
        # the worker thread): 4 ms, then an idle gap in backward
        _ev(rt, "cudaLaunchKernel", 100.0215, corr=5),
        _ev(k, "reduce", 100.0220, 5e-3, corr=5),
        _ev("cuda_driver", "cuLaunchKernel", 100.0260, corr=4, tid=2),
        _ev(k, "fused_shade_bwd", 100.0270, 4e-3, corr=4),
        # adam: a copy to the host and its stream synchronize (one sync),
        # then 6 ms
        _ev(rt, "cudaMemcpyAsync", 100.0419, corr=9),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 100.0420, 1e-4,
            corr=9),
        _ev(rt, "cudaStreamSynchronize", 100.04195),
        _ev(rt, "cudaLaunchKernel", 100.0450, corr=6),
        _ev(k, "adam", 100.0450, 6e-3, corr=6),
        # step, outside train_step: 0.25 ms
        _ev(rt, "cudaLaunchKernel", 100.0490, corr=8),
        _ev(k, "copy", 100.0510, 2.5e-4, corr=8),
        # no launch in the trace: 0.5 ms unattributed
        _ev(k, "orphan", 100.0600, 5e-4, corr=7),
        # the window's closing synchronize
        _ev(rt, "cudaDeviceSynchronize", 100.0990),
    ]


def _traced(recording=True):
    tr = T.Traced()
    tr.anchor = 100.0
    tr.host_spans = list(BENCH)
    if recording:
        tr.recording = {"spans": [program_span(*s) for s in PROGRAM],
                        "counters": {"head_live_rows": 30, "head_rows": 40}}
    return tr.load(_events())


def program_span(name, id_, parent, tid, s, e):
    from fgs_nerf_tpu_torch.utils.profiling import SpanRecord

    return SpanRecord(name, id_, parent, tid, s, e)


def _rr(kind="train", tr=None, units=1):
    rec = {"bounds": {"serve B1": 1e-4}, "head_flops_per_row": 1e3,
           "e2e": dict(units=4, work=4 * 8192, window_s=1.0, step_ms=[250.0] * 4,
                       host_ms=[240.0] * 4, peak=2 ** 30),
           "traced": {"trace": tr or _traced(), "units": units}}
    return harness.run_record(rec, kind, 9.0)


def test_device_time_goes_to_the_innermost_span_at_launch():
    p = program.entry(_traced())
    got = {k: round(v * 1e3, 6) for k, v in p["device_s"].items()}
    assert got == {"draw": 1.0, "train_step/forward": 2.1,
                   "train_step/forward/shade": 3.0,
                   "train_step/backward": 5.0,
                   "train_step/backward/shade": 4.0,
                   "train_step/adam": 6.1, "step": 0.25}
    assert p["unattributed_s"] == pytest.approx(0.5e-3)
    assert p["device_total_s"] == pytest.approx(21.95e-3)
    # one synchronize and one uncovered copy in forward, one copy with its
    # stream synchronize in adam; the closing synchronize in no span
    assert p["syncs"] == {"train_step/forward": 2, "train_step/adam": 1,
                          "none": 1}
    assert p["sync_calls"] == {"cudaDeviceSynchronize": 2,
                               "cudaMemcpy DtoH": 1,
                               "cudaStreamSynchronize after DtoH": 1}
    assert p["host_s"]["shade"] == pytest.approx(0.011)
    assert p["spans"][0] == ["train_step", pytest.approx(5100.003),
                             pytest.approx(5100.048)]


def test_a_benchmark_span_inside_a_program_span_adds_its_name():
    att = program.Attribution(
        [program_span("render_view", 0, None, 1, 10.0, 20.0),
         program_span("shade", 1, 0, 1, 12.0, 13.0)],
        [("view", 9.0, 21.0), ("chunk", 11.0, 14.0)], 0.0)
    assert att.paths([9.5, 10.5, 11.5, 12.5, 15.0, 30.0]) == [
        "view", "render_view", "render_view/chunk", "render_view/shade",
        "render_view", None]


NEW = {  # the metric files that read the program's entry, on this trace
    "device_ms.forward.train": 5.1, "device_ms.shade.train": 3.0,
    "device_ms.backward.train": 9.0, "device_ms.adam.train": 6.1,
    "device_ms.tv.train": 0.0, "head_fill.train": 75.0,
    "syncs_per_step.train": 3.0, "syncs_per_step.coarse": 3.0,
    "host_ms.forward.coarse": 16.0, "host_ms.backward.coarse": 19.0,
    "host_ms.adam.coarse": 6.0}
NEW_EVAL = ("host_ms_per_view.rays.eval", "host_ms_per_view.score.eval",
            "syncs_per_view.eval")


def test_run_record_carries_the_program_entry():
    tr = _traced()
    assert tr.offset == pytest.approx(OFF)
    rr = _rr(tr=tr)
    assert rr["program"] == program.entry(tr)
    assert rr["program"]["counters"] == {"head_live_rows": 30, "head_rows": 40}
    assert _rr(tr=_traced(recording=False))["program"] is None


def test_the_readers():
    spec = Spec()
    rr = _rr()
    for name, want in NEW.items():
        assert spec.reader(name)(rr) == pytest.approx(want), name
    # the idle gap inside backward is named by the program's span in the
    # breakdown, and by the benchmark's alone without the program's
    gaps = dict((round(1e3 * sec, 6), name) for name, sec in
                harness.breakdown(rr)["idle_gaps"])
    assert gaps[11.0] == "backward"
    assert record.named_gaps(rr["device"], rr["spans"], rr["t0"],
                             rr["t1"])[1] == ["step", pytest.approx(11e-3)]


def test_the_eval_metric_files_read_the_render_spans():
    tr = T.Traced()
    tr.anchor = 100.0
    tr.host_spans = [("window", *WINDOW), ("view", 100.002, 100.098)]
    tr.recording = {"spans": [
        program_span("render_view", 0, None, 1, 100.0030, 100.0970),
        program_span("rays", 1, 0, 1, 100.0040, 100.0060),
        program_span("to_host", 2, 0, 1, 100.0070, 100.0090),
        program_span("score", 3, 0, 1, 100.0400, 100.0900)], "counters": {}}
    tr.load(_events())
    rr = _rr("eval", tr=tr)
    spec = Spec()
    assert spec.reader("host_ms_per_view.rays.eval")(rr) == pytest.approx(2.0)
    assert spec.reader("host_ms_per_view.score.eval")(rr) == pytest.approx(50.0)
    # forward's synchronize and uncovered copy, adam's copy
    assert spec.reader("syncs_per_view.eval")(rr) == 3.0


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_readers_of_other_kinds_and_of_no_recording_read_nothing(kind):
    spec = Spec()
    rr = _rr(kind)
    other = NEW_EVAL if kind == "train" else tuple(NEW)
    for name in other:
        assert spec.reader(name)(rr) is None, name
    rr["program"] = None          # a program without the recorder
    for name in tuple(NEW) + NEW_EVAL:
        assert spec.reader(name)(rr) is None, name
    assert program.entry(_traced(recording=False)) is None


def test_existing_keys_and_readers_are_unchanged():
    """``run_record`` of the same window with and without the program's
    recording: the same keys and values besides ``program``, and every
    metric of ``BENCHMARK.json`` but the ``*_mfu`` and the new ones reads
    the same."""
    old = _rr(tr=_traced(recording=False))
    new = _rr()
    assert set(new) == set(old) == {
        "kind", "bounds", "head_flops_per_row", "e2e", "units", "window_s",
        "busy_s", "device", "spans", "t0", "t1", "groups", "program"}
    assert all(old[k] == new[k] for k in old if k != "program")
    spec = Spec()
    for m in spec.doc["end_to_end"] + spec.doc["per_layer"]:
        if m["name"] in NEW or m["name"].endswith("_mfu"):
            continue
        assert spec.reader(m["name"])(new) == spec.reader(m["name"])(old), m


def test_a_window_without_the_trace_never_turns_the_recorder_on(monkeypatch):
    """``--trace 0``: the drivers' windows open ``traced(dev, False)``, and
    the recorder stays off through a whole tiny cell."""
    from benchmark.tests.tiny import tiny_cell
    from fgs_nerf_tpu_torch.utils import profiling

    def refuse():
        raise AssertionError("the recorder was turned on")

    monkeypatch.setattr(profiling, "enable", refuse)
    with T.traced("cpu", on=False) as tr:
        assert tr is None
    D, cell = tiny_cell("dtu", "coarse_train")
    rec = D.run(cell, 0.2)
    assert rec["e2e"]["units"] >= 1 and "traced" not in rec
    assert not profiling.recording()
