"""The device time of a traced window credited to the span that launched
it, the synchronizing calls, and the operator's view of one cell.

    python -m benchmark.program --workload <cell> --seed <n> --seconds <s>

runs one cell as ``python -m benchmark.harness ... --trace 1`` does and
prints one JSON line for the operator: the cell's per-layer readings,
the traced window's numbers (``harness.trace_line``: ``cost``,
``unattributed``, the counters) with the records that went
unattributed, the breakdown's idle gaps, and :func:`summary`.  The
harness reads the same recording: its traced window (``trace.traced``)
turns the program's recorder (``fgs_nerf_tpu_torch/utils/profiling.py``)
on, ``harness.run_record`` carries :func:`entry` as ``program``, and the
metric files read it through ``readers.py``.

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
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import trace as T

SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
         "cudaEventSynchronize")


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


def entry(tr: T.Traced) -> Optional[Dict]:
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
    from benchmark.spec import Spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    harness._cache_env()
    import torch

    if not torch.cuda.is_available():
        print("benchmark.program: a CUDA device is needed", file=sys.stderr)
        return 2
    spec = Spec()
    rec, rr = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                               trace=True)
    out = {"workload": args.workload, "seed": args.seed,
           "correct": all(rec["readings"][k] <= lim
                          for k, lim in spec.limits(args.workload).items()),
           "trace": harness.trace_line(rec, rr),
           "busy_ms_per_unit": 1e3 * rr["busy_s"] / rr["units"],
           "units": rr["units"], "card": harness.card_line()}
    metrics = {}
    for m in spec.per_layer(args.workload):
        val = spec.reader(m["name"])(rr)
        if val is not None:
            metrics[m["name"]] = val
    out["metrics"] = metrics
    if rr["program"] is not None:
        out["unattributed_top"] = rr["program"]["unattributed_top"]
        out["program"] = summary(rr)
    out["idle_gaps"] = harness.breakdown(rr)["idle_gaps"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
