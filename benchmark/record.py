"""Arithmetic over what a window leaves: rates, tails, the device's busy
intervals, idle gaps and the kernel groups.

``BUCKETS`` is a frozen copy of ``chip_smoke.py:_BUCKETS`` (kernel name
fragments -> group, first match wins); a later group is a file of its
own (``groups/``), which takes only the names ``BUCKETS`` leave as
"other".
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

BUCKETS = (
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


FROZEN_NAMES = frozenset([b for b, _ in BUCKETS] + ["other"])


def bucket(kernel: str, groups: Sequence = ()) -> str:
    """The group of a device kernel's name: the first of ``BUCKETS`` that
    matches, else the one of ``groups`` (``groups.load()``) that matches,
    else "other".  Two of ``groups`` that match raise ``ValueError``."""
    frozen = next((b for b, frags in BUCKETS
                   if any(f in kernel for f in frags)), None)
    if frozen is not None:
        return frozen
    found = [g.name for g in groups if any(f in kernel for f in g.fragments)]
    if len(found) > 1:
        raise ValueError(f"the kernel {kernel!r} matches the group files "
                         f"{found}")
    return found[0] if found else "other"


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) with linear interpolation between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError("a window needs a positive length")
    return work / seconds


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_within(intervals, t0: float, t1: float) -> float:
    """Length of the union of ``intervals`` clipped to [t0, t1]."""
    return sum(max(0.0, min(e, t1) - max(s, t0)) for s, e in union(intervals))


def idle_share(intervals, t0: float, t1: float) -> float:
    """1 - busy / window over [t0, t1]."""
    return 1.0 - busy_within(intervals, t0, t1) / (t1 - t0)


def gaps(intervals, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The idle (start, end) spans of [t0, t1] between busy intervals."""
    out, cur = [], t0
    for s, e in union(intervals):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


def span_at(spans: Sequence[Tuple[str, float, float]], t: float) -> str:
    """Name of the innermost host span open at ``t`` ("none")."""
    best, best_len = "none", math.inf
    for name, s, e in spans:
        if s <= t < e and e - s < best_len:
            best, best_len = name, e - s
    return best


def named_gaps(device_intervals, spans, t0: float, t1: float, top: int = 10):
    """The ``top`` longest idle gaps, each named by the host span open at
    its middle: [[name, seconds], ...] (times in seconds)."""
    g = sorted(gaps(device_intervals, t0, t1), key=lambda x: x[0] - x[1])
    return [[span_at(spans, (s + e) / 2), e - s] for s, e in g[:top]]


def group_seconds(kernels: Iterable[Tuple[str, float, float]],
                  groups: Sequence = ()) -> Dict[str, float]:
    """Device seconds by ``bucket`` of (name, start, end) kernel events."""
    out: Dict[str, float] = {}
    names: Dict[str, str] = {}
    for name, s, e in kernels:
        if name not in names:
            names[name] = bucket(name, groups)
        b = names[name]
        out[b] = out.get(b, 0.0) + (e - s)
    return out
