"""The program's own spans and counters in a traced window, and the device
time credited to the span that launched it.

    python -m benchmark.program --workload <cell> --seed <n> --seconds <s>

runs one cell as ``python -m benchmark.harness ... --trace 1`` does, with
the program's recorder (``fgs_nerf_tpu_torch/utils/profiling.py``) on for
the traced window alone, and prints one JSON line: the readings below,
``trace.cost`` and ``trace.unattributed``, the breakdown's idle gaps
named by program spans too, and the ``program`` entry.  The harness does
not read these yet: its traced window (``trace.traced``) would have to
turn the recorder on and keep each record's launch, and ``run_record``
carry :func:`entry` as ``program`` (PERF.md, open questions).

Attribution.  Each kernel, copy or memset record of the CUDA trace
shares a ``correlation`` id with the runtime or driver call that
launched it, whose host time is on the trace's clock; the program's
spans (``perf_counter``) are placed on that clock by the same anchor as
the benchmark's own (``trace.py``).  A record is credited to the
innermost span open at its launch, the program's or the benchmark's,
by the program span's path of names (``train_step/forward/shade``; a
benchmark span inside it adds its name, and one outside every program
span stands alone: ``draw``).  Records with no launch found, or launched
outside every span, are unattributed.  A synchronizing call is a
``cudaDeviceSynchronize``, ``cudaStreamSynchronize`` or
``cudaEventSynchronize``, or a ``cudaMemcpy*`` whose correlated copy
runs device to host and that no synchronize follows on its thread
(once per copy); ``sync_calls`` names each with the copy before it
(``cudaStreamSynchronize after HtoD``: a tensor made on the device from
host data).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import record
from benchmark import trace as T

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
         "cudaEventSynchronize")


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from fgs_nerf_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") else None


class ProgramTraced(T.Traced):
    """``trace.Traced`` that also keeps every device record with its
    launch, the runtime calls, and the program's recording."""

    def __init__(self):
        super().__init__()
        # cat, name, start, end, launch time (None: no launch found)
        self.records: List[Tuple[str, str, float, float, Optional[float]]] = []
        self.calls: List[Tuple[str, float, int, Optional[int]]] = []  # name, t, tid, corr
        self.copies: Dict[int, str] = {}  # correlation -> "HtoD", "DtoH", ...
        self.recording: Dict = {"spans": [], "counters": {}}
        self.offset: Optional[float] = None   # trace clock less perf_counter

    def load(self, events: List[Dict]) -> "ProgramTraced":
        super().load(events)
        win = [s for name, s, _ in self.host_spans if name == "window"]
        if self.anchored and win:
            self.offset = self.window[0] - win[0]
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "ts" in e:
                corr = e.get("args", {}).get("correlation")
                t = float(e["ts"]) * 1e-6
                if corr is not None:
                    launch.setdefault(corr, t)
                if e["cat"] == "cuda_runtime":
                    self.calls.append((e.get("name", ""), t, e.get("tid", 0), corr))
        for e in events:
            if e.get("cat") in T.DEVICE_CATS and "ts" in e and "dur" in e:
                s = float(e["ts"]) * 1e-6
                corr = e.get("args", {}).get("correlation")
                self.records.append((e["cat"], e.get("name", ""), s,
                                     s + float(e["dur"]) * 1e-6, launch.get(corr)))
                if e["cat"] == "gpu_memcpy":
                    # "Memcpy DtoH (Device -> Pageable)"
                    self.copies[corr] = (e.get("name", "").split() + ["", ""])[1]
        return self


@contextlib.contextmanager
def traced(device, on: bool = True):
    """``trace.traced`` with the program's recorder on inside the window
    and a :class:`ProgramTraced` as its result (None where ``on`` is
    false: the recorder stays off)."""
    import torch

    if not on:
        yield None
        return
    prog = recorder()
    out = ProgramTraced()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out.anchor = time.perf_counter()
        torch.cuda.synchronize(device)
        T._spans = out.host_spans
        if prog is not None:
            prog.enable()
        try:
            yield out
        finally:
            T._spans = None
            if prog is not None:
                out.recording = prog.export()
                prog.disable()
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out.load(json.load(f)["traceEvents"])
    finally:
        os.remove(path)


def innermost(spans: Sequence[Tuple[float, float]], times: Sequence[float]
              ) -> List[Optional[int]]:
    """For each time, the index of the shortest of ``spans`` ((start,
    end), half open) open at it, else None: one sweep."""
    ev = [(s, 1, i) for i, (s, _) in enumerate(spans)]
    ev += [(e, 0, i) for i, (_, e) in enumerate(spans)]
    ev += [(t, 2, j) for j, t in enumerate(times)]
    ev.sort(key=lambda x: (x[0], x[1]))
    open_: Dict[int, float] = {}
    out: List[Optional[int]] = [None] * len(times)
    for _, kind, i in ev:
        if kind == 0:
            open_.pop(i, None)
        elif kind == 1:
            open_[i] = spans[i][1] - spans[i][0]
        else:
            out[i] = min(open_, key=open_.get) if open_ else None
    return out


def _paths(spans) -> List[str]:
    by_id = {s[1]: s for s in spans}
    memo: Dict[int, str] = {}

    def path(s):
        if s[1] not in memo:
            up = by_id.get(s[2])
            memo[s[1]] = (path(up) + "/" if up is not None else "") + s[0]
        return memo[s[1]]
    return [path(s) for s in spans]


class Attribution:
    """Times on the trace's clock -> the span path credited with them."""

    def __init__(self, program_spans, bench_spans, offset: float):
        self.prog = [(p, s[4] + offset, s[5] + offset)
                     for p, s in zip(_paths(program_spans), program_spans)]
        self.bench = list(bench_spans)

    def paths(self, times: Sequence[float]) -> List[Optional[str]]:
        ip = innermost([(s, e) for _, s, e in self.prog], times)
        ib = innermost([(s, e) for _, s, e in self.bench], times)
        out = []
        for p, b in zip(ip, ib):
            if p is None:
                out.append(None if b is None else self.bench[b][0])
                continue
            path, s, e = self.prog[p]
            if b is not None:
                _, bs, be = self.bench[b]
                if be - bs < e - s:
                    path += "/" + self.bench[b][0]
            out.append(path)
        return out


def entry(tr: ProgramTraced) -> Optional[Dict]:
    """The ``program`` entry of a traced window (None where the trace
    has no anchor or the program recorded nothing): the program's spans
    on the trace's clock, device seconds by span path and unattributed,
    host seconds by span name, synchronizing calls by span path, and the
    counters."""
    spans = tr.recording["spans"]
    if tr.offset is None or not spans:
        return None
    att = Attribution(spans, tr.spans, tr.offset)
    t0, t1 = tr.window
    recs = [(name, min(e, t1) - max(s, t0), launch)
            for _, name, s, e, launch in tr.records if e > t0 and s < t1]
    paths = iter(att.paths([t for _, _, t in recs if t is not None]))
    device_s: Dict[str, float] = {}
    lost: Dict[str, float] = {}       # unattributed seconds by record name
    for name, sec, t in recs:
        path = next(paths) if t is not None else None
        if path is None:
            lost[name] = lost.get(name, 0.0) + sec
        else:
            device_s[path] = device_s.get(path, 0.0) + sec
    total = sum(sec for _, sec, _ in recs)
    calls = sorted((c for c in tr.calls if t0 <= c[1] < t1),
                   key=lambda c: (c[2], c[1]))
    sync_t = []
    kinds: Dict[str, int] = {}        # each call, with the copy before it
    for k, (name, t, tid, corr) in enumerate(calls):
        prev = calls[k - 1] if k and calls[k - 1][2] == tid else None
        nxt = calls[k + 1] if k + 1 < len(calls) else None
        followed = nxt is not None and nxt[2] == tid and nxt[0] in SYNCS
        if name in SYNCS:
            after = prev and prev[0].startswith("cudaMemcpy") \
                and tr.copies.get(prev[3])
            kind = f"{name} after {after}" if after else name
        elif name.startswith("cudaMemcpy") and not followed \
                and tr.copies.get(corr) == "DtoH":
            kind = f"{name} DtoH"
        else:
            continue
        sync_t.append(t)
        kinds[kind] = kinds.get(kind, 0) + 1
    syncs: Dict[str, int] = {}
    for path in att.paths(sync_t):
        key = path or "none"
        syncs[key] = syncs.get(key, 0) + 1
    host_s: Dict[str, float] = {}
    for s in spans:
        host_s[s[0]] = host_s.get(s[0], 0.0) + (s[5] - s[4])
    return {"spans": [[p, s, e] for p, s, e in att.prog],
            "device_s": device_s,
            "unattributed_s": sum(lost.values()),
            "unattributed_top": sorted(lost.items(), key=lambda kv: -kv[1])[:5],
            "device_total_s": total, "host_s": host_s, "syncs": syncs,
            "sync_calls": kinds,
            "counters": dict(tr.recording["counters"])}


# ---- readers of the ``program`` entry ---------------------------------


def _under(table: Dict, prefix: str):
    return sum(v for k, v in table.items()
               if k == prefix or k.startswith(prefix + "/"))


def device_ms(path: str, kind: str = "train"):
    """Device ms a unit credited to the spans under ``path``."""
    def read(rec):
        p = rec.get("program")
        if rec["kind"] != kind or not p or not rec.get("units"):
            return None
        return 1e3 * _under(p["device_s"], path) / rec["units"]
    return read


def host_ms(name: str, kind: str):
    """Host ms a unit inside the program's spans named ``name``."""
    def read(rec):
        p = rec.get("program")
        if rec["kind"] != kind or not p or not rec.get("units") \
                or name not in p["host_s"]:
            return None
        return 1e3 * p["host_s"][name] / rec["units"]
    return read


def syncs_per_unit(root: str, kind: str):
    """Synchronizing calls a unit under the span path ``root``."""
    def read(rec):
        p = rec.get("program")
        if rec["kind"] != kind or not p or not rec.get("units"):
            return None
        return _under(p["syncs"], root) / rec["units"]
    return read


def head_fill(rec: Dict) -> Optional[float]:
    """100 x the shading head's live rows over the rows it computed."""
    p = rec.get("program")
    c = p["counters"] if p else {}
    if rec["kind"] != "train" or not c.get("head_rows"):
        return None
    return 100.0 * c["head_live_rows"] / c["head_rows"]


READERS = {
    "device_ms.forward.train": device_ms("train_step/forward"),
    "device_ms.shade.train": device_ms("train_step/forward/shade"),
    "device_ms.backward.train": device_ms("train_step/backward"),
    "device_ms.tv.train": device_ms("train_step/tv"),
    "device_ms.adam.train": device_ms("train_step/adam"),
    "head_fill.train": head_fill,
    "syncs_per_step.train": syncs_per_unit("train_step", "train"),
    "host_ms.forward.coarse": host_ms("forward", "train"),
    "host_ms.backward.coarse": host_ms("backward", "train"),
    "host_ms.adam.coarse": host_ms("adam", "train"),
    "syncs_per_step.coarse": syncs_per_unit("train_step", "train"),
    "host_ms_per_view.rays.eval": host_ms("rays", "eval"),
    "host_ms_per_view.score.eval": host_ms("score", "eval"),
    "syncs_per_view.eval": syncs_per_unit("render_view", "eval"),
}


def summary(rr: Dict) -> Dict:
    """What the line shows of the ``program`` entry: a unit's device ms by
    the first two names of each path, host ms by span, syncs by path."""
    p, u = rr["program"], rr["units"]
    dev: Dict[str, float] = {}
    for path, sec in p["device_s"].items():
        key = "/".join(path.split("/")[:2])
        dev[key] = dev.get(key, 0.0) + 1e3 * sec / u
    return {"device_ms": dev,
            "host_ms": {k: 1e3 * v / u for k, v in p["host_s"].items()},
            "syncs": {k: v / u for k, v in p["syncs"].items()},
            "sync_calls": {k: v / u for k, v in p["sync_calls"].items()},
            "counters": p["counters"]}


def main(argv: Optional[List[str]] = None) -> int:
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    harness._cache_env()
    import importlib

    import torch

    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("benchmark.program: a CUDA device is needed", file=sys.stderr)
        return 2
    spec = Spec()
    wl = spec.workload(args.workload)
    cfg, traffic = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.build_kernels()
    T.traced = traced
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    marks = {}
    rec = driver.run(driver.Cell(cfg, traffic, args.seed, dev), args.seconds,
                     float(traffic["trace_seconds"]),
                     on_setup_done=lambda: marks.setdefault(
                         "setup_s", time.perf_counter() - harness.T_START))
    rr = harness.run_record(rec, traffic["kind"], marks["setup_s"])
    tr = rec["traced"]["trace"]
    rr["program"] = entry(tr)
    e, t = rec["e2e"], rec["traced"]
    out = {"workload": args.workload, "seed": args.seed,
           "correct": all(rec["readings"][k] <= lim
                          for k, lim in spec.limits(args.workload).items()),
           "trace": {"cost": (t["window_s"] / t["units"])
                     / (e["window_s"] / e["units"])},
           "busy_ms_per_unit": 1e3 * rr["busy_s"] / rr["units"],
           "units": rr["units"], "card": harness.card_line()}
    metrics = {}
    for m in spec.per_layer(args.workload):
        val = spec.reader(m["name"])(rr)
        if val is not None:
            metrics[m["name"]] = val
    suffix = ".coarse" if traffic.get("stage") == "coarse" else (
        ".eval" if traffic["kind"] == "eval" else ".train")
    for name, read in READERS.items():
        if name.endswith(suffix):
            val = read(rr)
            if val is not None:
                metrics[name] = val
    out["metrics"] = metrics
    p = rr["program"]
    if p is not None:
        out["trace"]["unattributed"] = p["unattributed_s"] / p["device_total_s"]
        out["unattributed_top"] = p["unattributed_top"]
        out["program"] = summary(rr)
        # idle gaps named by the innermost span, the program's by its name
        spans = rr["spans"] + [(path.split("/")[-1], s, e)
                               for path, s, e in p["spans"]]
        out["idle_gaps"] = record.named_gaps(rr["device"], spans, rr["t0"],
                                             rr["t1"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
