"""What the metric readers share.  Each ``metrics/<name>.py`` binds its
``read`` to one of these, with the kernel group or the kind of traffic
it reads, so that a metric is still one file of its own.

A reader takes the run's record and returns a number, or ``None`` where
it finds nothing to read (the harness then leaves the metric out).  The
record (``harness.run_record``) holds:

* ``e2e``: the untraced window: ``units`` (steps or views) and ``work``
  (rays) done, ``window_s``, ``step_ms`` (CUDA-event intervals),
  ``host_ms`` (the benchmark's span a step), ``peak`` (bytes)
  and ``setup_s``;
* with ``--trace 1`` also the traced window: ``units``, ``window_s``,
  ``busy_s``, ``device`` (busy intervals), ``t0`` / ``t1``, ``groups``
  (device seconds by kernel group) and ``program`` (``program.entry``:
  device seconds by the program's span path, host seconds by span name,
  synchronizing calls by span path, and the program's counters; None
  where the program recorded nothing);
* the cell's ``kind``, ``bounds`` (least seconds a step of each kernel
  group's logical work) and ``head_flops_per_row`` (the heads' FLOPs a
  row they shade).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from benchmark import record
from benchmark.counts import PEAKS

Reader = Callable[[Dict], Optional[float]]


# ---- end-to-end: the untraced window ---------------------------------


def rays_per_s(rec: Dict) -> Optional[float]:
    """Rays of every step (or scored view) in the window over its
    seconds."""
    e = rec["e2e"]
    return record.rate(e["work"], e["window_s"]) if e["units"] else None


def step_ms_p90(rec: Dict) -> Optional[float]:
    """The 90th percentile of the window's step intervals."""
    ms = rec["e2e"].get("step_ms")
    return record.percentile(ms, 90) if ms else None


def peak_mem_gib(rec: Dict) -> Optional[float]:
    return rec["e2e"]["peak"] / 2 ** 30


def setup_s(rec: Dict) -> Optional[float]:
    return rec["e2e"]["setup_s"]


# ---- per layer --------------------------------------------------------


def host_ms_per_step(rec: Dict) -> Optional[float]:
    """The benchmark's span around the batch draw and the step call, with
    no synchronize, averaged over the untraced window's steps."""
    ms = rec["e2e"].get("host_ms")
    if rec["kind"] != "train" or not ms:
        return None
    return sum(ms) / len(ms)


def mfu(kind: str) -> Reader:
    """The heads' product FLOPs of the rows they shade live, over the
    untraced window's seconds times the bf16 peak, in percent: the traced
    window's ``head_live_rows`` a unit (step or view), times each row's
    FLOPs, times the untraced window's units."""
    def read(rec):
        e, p = rec["e2e"], rec.get("program")
        live = p["counters"].get("head_live_rows") if p else None
        if rec["kind"] != kind or not e["units"] or not live \
                or not rec.get("units"):
            return None
        return (100.0 * live / rec["units"] * rec["head_flops_per_row"]
                * e["units"] / (e["window_s"] * PEAKS["bf16_flops"]))
    return read


def idle_share(kind: str) -> Reader:
    """Percent of the traced window in which no kernel, copy or memset
    ran on the device."""
    def read(rec):
        if rec["kind"] != kind or not rec.get("device"):
            return None
        return 100.0 * record.idle_share(rec["device"], rec["t0"], rec["t1"])
    return read


def device_ms(group: str) -> Reader:
    """Device milliseconds a step in one kernel group, over the traced
    window."""
    def read(rec):
        sec = rec.get("groups", {}).get(group)
        if rec["kind"] != "train" or not sec or not rec["units"]:
            return None
        return 1e3 * sec / rec["units"]
    return read


def device_ms_per_view(rec: Dict) -> Optional[float]:
    """Device-busy milliseconds a scored view over the traced window."""
    if rec["kind"] != "eval" or not rec.get("units"):
        return None
    return 1e3 * rec["busy_s"] / rec["units"]


def roofline(group: str) -> Reader:
    """A kernel group's share of its roofline, in percent: the least time
    of the logical work it does a step (``counts.kernel_bounds``) over its
    traced device time a step."""
    def read(rec):
        sec = rec.get("groups", {}).get(group)
        bound = rec["bounds"].get(group)
        if not sec or not bound or not rec.get("units"):
            return None
        return 100.0 * bound * rec["units"] / sec
    return read


# ---- the program's spans and counters (``program.entry``) -------------


def _under(table: Dict, prefix: str):
    return sum(v for k, v in table.items()
               if k == prefix or k.startswith(prefix + "/"))


def span_device_ms(path: str, kind: str) -> Reader:
    """Device ms a unit credited to the program's spans under ``path``."""
    def read(rec):
        p = rec.get("program")
        if rec["kind"] != kind or not p or not rec.get("units"):
            return None
        return 1e3 * _under(p["device_s"], path) / rec["units"]
    return read


def span_host_ms(name: str, kind: str) -> Reader:
    """Host ms a unit inside the program's spans named ``name``."""
    def read(rec):
        p = rec.get("program")
        if rec["kind"] != kind or not p or not rec.get("units") \
                or name not in p["host_s"]:
            return None
        return 1e3 * p["host_s"][name] / rec["units"]
    return read


def span_syncs(root: str, kind: str) -> Reader:
    """Synchronizing calls a unit under the program's span path ``root``."""
    def read(rec):
        p = rec.get("program")
        if rec["kind"] != kind or not p or not rec.get("units"):
            return None
        return _under(p["syncs"], root) / rec["units"]
    return read


def head_fill(kind: str) -> Reader:
    """100 x the shading head's live rows over the rows it computed."""
    def read(rec):
        p = rec.get("program")
        c = p["counters"] if p else {}
        if rec["kind"] != kind or not c.get("head_rows"):
            return None
        return 100.0 * c.get("head_live_rows", 0) / c["head_rows"]
    return read
