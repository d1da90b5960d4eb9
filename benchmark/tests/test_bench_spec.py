"""Discovery by name, the contract's characters, and a cell added by
data files alone."""
import json
import re
import shutil

import pytest

from benchmark import spec as S

ROOT = S.ROOT
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_and_unit_uses_the_allowed_characters():
    names = ([c["name"] for c in DOC["configs"]] + [w["name"] for w in DOC["workloads"]]
             + [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
             + [w["config"] for w in DOC["workloads"]]
             + [w["traffic"] for w in DOC["workloads"]]
             + [k for c in DOC["configs"] for k in c["reduced"]])
    assert all(S.NAME_RE.match(n) for n in names), names
    units = [m["unit"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert all(S.UNIT_RE.match(u) for u in units), units
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in DOC[group]]
        assert len(got) == len(set(got))
    for text in ([w["why"] for w in DOC["workloads"]]
                 + [m["layer"] for m in DOC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_entry_is_found_by_its_name():
    spec = S.Spec()
    for wl in DOC["workloads"]:
        cfg = spec.config(wl["config"])
        tr = spec.traffic(wl["traffic"])
        lim = spec.limits(wl["name"])
        assert cfg["name"] == wl["config"] and tr["kind"] in ("train", "eval")
        assert lim and all(v > 0 for v in lim.values())
        assert any(m["name"] == "setup_s" for m in spec.end_to_end(wl["name"]))
        assert len(spec.end_to_end(wl["name"])) >= 2
        assert spec.per_layer(wl["name"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for m in DOC["per_layer"]:
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
        moved = next(e for e in DOC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for c in DOC["configs"]:
        assert c["file"].startswith("benchmark/")


def _record(kind, units, traced):
    e2e = dict(units=units, work=8192 * units, window_s=2.0, step_ms=[200.0] * units,
               host_ms=[150.0] * units, peak=2 ** 31, setup_s=12.5)
    rec = dict(kind=kind, bounds={"serve B1": 1e-3} if units else {},
               head_flops_per_row=1e9, e2e=e2e)
    if traced:
        rec.update(units=units, window_s=2.0, busy_s=1.5, device=[(0.0, 1.5)],
                   spans=[], t0=0.0, t1=2.0, groups={"serve B1": 4e-3 * units},
                   program={"device_s": {}, "host_s": {}, "syncs": {},
                            "counters": {"head_live_rows": 1000 * units,
                                         "head_rows": 2000 * units}})
    return rec


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_readers_leave_out_what_they_cannot_read(kind):
    spec = S.Spec()
    for m in DOC["per_layer"]:
        assert spec.reader(m["name"])(_record(kind, 0, False)) is None, m["name"]


def test_readers_read_the_windows_they_name():
    spec = S.Spec()
    rec = _record("train", 10, True)
    assert spec.reader("train_rays_per_s")(rec) == 8192 * 10 / 2.0
    assert spec.reader("train_step_ms_p90")(rec) == 200.0
    assert spec.reader("peak_mem_gib")(rec) == 2.0
    assert spec.reader("setup_s")(rec) == 12.5
    assert spec.reader("host_ms_per_step.coarse")(rec) == 150.0
    assert spec.reader("idle_share.train")(rec) == pytest.approx(25.0)
    assert spec.reader("coarse.B1_roofline")(rec) == pytest.approx(25.0)
    # the mfu is taken over the untraced window: 10 steps of 1,000 live
    # rows of 1 GFLOP in 2 s
    peak = S.load_reader(S.BENCH_DIR / "metrics" / "train_mfu.py")
    assert peak(rec) == pytest.approx(100 * 10e12 / (2.0 * 989e12))
    assert spec.reader("eval_mfu")(rec) is None


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    mix = json.loads((bench / "traffic" / "fine_train.json").read_text())
    mix.update(first_step=16000, about="a throwaway mix")
    (bench / "traffic" / "fine_late.json").write_text(json.dumps(mix))
    (bench / "limits" / "shiny_blender.fine_late.json").write_text(
        (bench / "limits" / "shiny_blender.fine_train.json").read_text())
    (bench / "metrics" / "steps_traced.py").write_text(
        "def read(rec):\n    return float(rec['units']) or None\n")
    doc["workloads"].append({"name": "shiny_blender.fine_late", "config": "shiny_blender",
                             "traffic": "fine_late", "chips": 1, "why": "a throwaway cell"})
    doc["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                             "source": "program_counter", "layer": "train step",
                             "moves": "train_rays_per_s",
                             "workloads": ["shiny_blender.fine_late"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = S.Spec(root=tmp_path, bench_dir=bench)
    wl = spec.workload("shiny_blender.fine_late")
    assert spec.traffic(wl["traffic"])["first_step"] == 16000
    assert [m["name"] for m in spec.per_layer(wl["name"])][-1] == "steps_traced"
    assert spec.reader("steps_traced")({"units": 12}) == 12.0
    with pytest.raises(KeyError):
        spec.workload("shiny_blender.absent")


def test_step_keys_come_back_as_ints():
    cfg = S.Spec().config("shiny_blender")
    assert 15000 in cfg["fine_train"]["decay_step_module"]
    assert S.int_keys({"8001": {"a": 1}, "x": [{"12": 2}]}) == {8001: {"a": 1}, "x": [{12: 2}]}


def test_files_under_the_benchmark_have_names_of_names():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or "_cache" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./\-]+$", str(p.relative_to(ROOT))), p
