"""Profiling helpers: a ``torch.profiler`` trace and wall-clock buckets.

Port of ``fgs_nerf_tpu/utils/profiling.py``.  For deep dives
:func:`trace_steps` records a trace of the steps run inside it:

    with trace_steps("/tmp/tb") as trace:
        ... run steps ...
    print(trace.path)

and :class:`Buckets` accumulates wall-clock time of host-side phases
(the reference's time_log dict).  Nothing in the trainer calls either.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch


class Trace:
    """What :func:`trace_steps` leaves: the Chrome trace's ``path``, set
    when the block ends."""

    def __init__(self):
        self.path: Optional[str] = None

    def kernels(self) -> List[Tuple[str, float]]:
        """(name, microseconds) of each device kernel in the written trace."""
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        return [(e["name"], float(e.get("dur", 0.0))) for e in events
                if e.get("cat") == "kernel"]

    def kernel_events(self) -> int:
        """The count of device kernel events in the written trace."""
        return len(self.kernels())


@contextlib.contextmanager
def trace_steps(logdir: str, device="cuda"):
    """Record CPU and, on a CUDA device, CUDA activity of the enclosed
    steps; writes ``trace_<pid>_<n>.json`` (Chrome / Perfetto) under
    ``logdir``.  A CUDA device on a machine with no card raises: the
    trace never falls back to the CPU."""
    dev = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"trace_steps: device {dev} asked for, but this machine "
                "has no CUDA device; pass device='cpu' to trace the host")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    trace = Trace()
    with torch.profiler.profile(activities=activities) as prof:
        yield trace
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    trace.path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(trace.path)


class Buckets:
    """Accumulating wall-clock buckets (the reference's time_log dict)."""

    def __init__(self, *names: str):
        self.t: Dict[str, float] = {n: 0.0 for n in names}
        self._last = time.perf_counter()

    def tick(self, name: str) -> None:
        now = time.perf_counter()
        self.t[name] = self.t.get(name, 0.0) + (now - self._last)
        self._last = now

    def reset_clock(self) -> None:
        self._last = time.perf_counter()

    def summary(self) -> str:
        return " ".join(f"{k}:{v:.1f}s" for k, v in self.t.items())
