"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, one JSON file per configuration (``configs/<name>.json``),
per traffic mix (``traffic/<name>.json``) and per cell's limits
(``limits/<cell>.json``), one reader per metric (``metrics/<name>.py``,
a module with ``read(record)``) and one file per kernel group that the
frozen ``record.BUCKETS`` do not name (``groups/<group>.py``).  A later cell or
metric is added by adding files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def int_keys(tree: Any) -> Any:
    """JSON objects hold string keys; the step-indexed schedules of a
    stage (``decay_step_module``, ``tv_updates``, ...) are keyed by
    global step, so keys made of digits come back as ints."""
    if isinstance(tree, dict):
        return {(int(k) if isinstance(k, str) and k.isdigit() else k):
                int_keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [int_keys(v) for v in tree]
    return tree


class Spec:
    """``BENCHMARK.json`` with lookups by name."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.doc = load_json(self.root / "BENCHMARK.json")
        self.workloads = {w["name"]: w for w in self.doc["workloads"]}
        self.configs = {c["name"]: c for c in self.doc["configs"]}

    def workload(self, name: str) -> Dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.workloads)})")
        return self.workloads[name]

    def config(self, name: str) -> Dict:
        return int_keys(load_json(self.root / self.configs[name]["file"]))

    def traffic(self, name: str) -> Dict:
        return int_keys(load_json(self.bench_dir / "traffic" / f"{name}.json"))

    def limits(self, workload: str) -> Dict[str, float]:
        return load_json(self.bench_dir / "limits" / f"{workload}.json")

    def end_to_end(self, workload: str):
        return [m for m in self.doc["end_to_end"]
                if workload in m.get("workloads", self.workloads)]

    def per_layer(self, workload: str):
        return [m for m in self.doc["per_layer"]
                if workload in m.get("workloads", self.workloads)]

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        return load_reader(self.bench_dir / "metrics" / f"{metric}.py")


def load_module(path: Path, prefix: str):
    """A module of the benchmark's data loaded from its file (metric names
    hold dots, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(path: Path) -> Callable[[Dict], Optional[float]]:
    """``read`` of one metric's module, loaded from its file."""
    return load_module(path, "benchmark_metric_").read
