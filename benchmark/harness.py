"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.harness --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Each metric is read by ``metrics/<name>.py``.  With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics, read from the
window.  With ``--trace 1`` its per-layer metrics: the device's and the
program's spans and counters from a traced window that follows the
untraced one (``trace.py``, the program's recorder on), the host's from
the untraced window, which neither the profiler nor the recorder slows.
Every run also decides ``correct`` against the plain reference and
prints each compared number beside its limit, last on standard error
and last in the result line.  The run fails (exit 2, no result) without
a CUDA device, (exit 3) if JAX or the JAX package was loaded, and (exit
4) if an end-to-end metric has no reading.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

from benchmark import groups, program, record  # noqa: E402
from benchmark.spec import BENCH_DIR, Spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fgs_nerf_tpu")
CACHE_DIR = BENCH_DIR / "_cache"


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``fgs_nerf_tpu_torch`` is not ``fgs_nerf_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _cache_env() -> None:
    """Kernel caches at fixed paths inside the checkout; the program's
    own nvcc builds stay where it keeps them (``fgs_nerf_tpu_torch/
    _build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def build_kernels() -> None:
    """Every hand-written kernel of the program, built at once (nvcc in
    parallel on a cold checkout) and loaded."""
    import pkgutil

    import fgs_nerf_tpu_torch.ops.cuda as pkg
    from fgs_nerf_tpu_torch.ops.cuda.build import CudaKernel, build_all

    kernels = []
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        kernels += [v for v in vars(mod).values() if isinstance(v, CudaKernel)]
    build_all(kernels)


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool) -> Tuple[Dict, Dict]:
    """Set-up, the untraced window, with ``trace`` the traced window, and
    the reference of one cell on ``cuda:0``: the driver's record and what
    the metric readers read."""
    import torch

    wl = spec.workload(workload)
    traffic = spec.traffic(wl["traffic"])
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    marks = {}
    cell = driver.Cell(spec.config(wl["config"]), traffic, seed, dev)
    rec = driver.run(cell, seconds,
                     float(traffic["trace_seconds"]) if trace else 0.0,
                     on_setup_done=lambda: marks.setdefault(
                         "setup_s", time.perf_counter() - T_START))
    return rec, run_record(rec, traffic["kind"], marks["setup_s"])


def run_record(rec: Dict, kind: str, setup_s: float) -> Dict:
    """What the metric readers read (``readers``): the untraced window,
    and the traced window reduced to device intervals, kernel groups and
    the program's spans and counters (``program.entry``)."""
    out = dict(kind=kind, bounds=rec["bounds"],
               head_flops_per_row=rec["head_flops_per_row"],
               e2e=dict(rec["e2e"], setup_s=setup_s))
    tw = rec.get("traced")
    if tw is not None:
        tr = tw["trace"]
        t0, t1 = tr.window
        out.update(units=tw["units"], window_s=t1 - t0,
                   busy_s=record.busy_within(tr.device, t0, t1),
                   device=tr.device, spans=tr.spans, t0=t0, t1=t1,
                   groups=record.group_seconds(tr.kernels, groups.load()),
                   program=program.entry(tr))
    return out


def breakdown(rr: Dict) -> Dict:
    """The groups that took most device time, and the longest idle gaps,
    each named by the innermost span open at its middle, the program's
    (by its own name) or the benchmark's."""
    top = sorted(rr["groups"].items(), key=lambda kv: -kv[1])[:10]
    spans = rr["spans"] + [(path.split("/")[-1], s, e) for path, s, e
                           in (rr["program"] or {}).get("spans", ())]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": record.named_gaps(rr["device"], spans,
                                           rr["t0"], rr["t1"])}


def trace_line(rec: Dict, rr: Dict) -> Dict:
    """The traced window's own numbers: its time a unit over the untraced
    window's (``cost``) and, with the program's recording, the device
    seconds of its records, those credited to a span, the share credited
    to none (``unattributed``) and the program's counters."""
    e, t = rec["e2e"], rec["traced"]
    out = {"clock": "anchored" if t["trace"].anchored else "device_span",
           "cost": (t["window_s"] / t["units"]) / (e["window_s"] / e["units"]),
           "units": t["units"]}
    p = rr["program"]
    if p is not None:
        out.update(device_s=p["device_total_s"],
                   credited_s=sum(p["device_s"].values()),
                   unattributed=p["unattributed_s"] / p["device_total_s"],
                   counters=p["counters"])
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_env()
    import torch

    spec = Spec()
    wl = spec.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark: {wl['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "found", file=sys.stderr)
        return 2
    limits = spec.limits(args.workload)
    rec, rr = run_cell(spec, args.workload, args.seed, args.seconds,
                       bool(args.trace))
    readings = rec["readings"]
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    wanted = spec.per_layer(args.workload) if args.trace else spec.end_to_end(args.workload)
    metrics = {}
    for m in wanted:
        val = spec.reader(m["name"])(rr)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        elif not args.trace:
            print(f"benchmark: no reading of {m['name']}", file=sys.stderr)
            return 4
    extra = {"busy_s": rr["busy_s"], "window_s": rr["window_s"]} if args.trace else {}

    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": wl["chips"],
              "memory_peak_bytes": int(rec["peak"]),
              **extra}
    windows = [rec[w] for w in ("e2e", "traced") if w in rec]
    out = {"correct": correct, "attempted": sum(w["units"] for w in windows),
           "failed": sum(w["failed"] for w in windows), "metrics": metrics,
           "device": device}
    if args.trace:
        out["breakdown"] = breakdown(rr)
        out["trace"] = trace_line(rec, rr)
    out["card"] = card_line()
    out["window"] = {"seconds": rec["e2e"]["window_s"], "units": rec["e2e"]["units"],
                     "kept_rays": rec.get("n_kept"), "pixels": rec.get("n_pixels")}
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
