"""The traced window: ``torch.profiler`` with CUDA activity alone over the
window, with the program's span recorder on, reduced to device intervals
by kernel name, each device record with the host time of the call that
launched it, and the benchmark's own host spans and the program's
recording placed on the trace's clock.

The profiler records no host operator (CPU activity would slow a
host-paced step ~1.7x); the host spans are the drivers' ``span`` blocks,
timed with ``time.perf_counter``, and the program's
(``fgs_nerf_tpu_torch/utils/profiling.py``, on for the traced window
alone).  Both are placed on the trace's clock by the
``cudaDeviceSynchronize`` that :func:`traced` makes as the profile
starts, whose host time the trace records too.  The window is the span
``window``, which ends after the window's synchronize.  The Chrome trace
is written to a temporary file under ``TMPDIR`` and removed once read.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from benchmark import record

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ANCHOR = "cudaDeviceSynchronize"

_spans: Optional[List[Tuple[str, float, float]]] = None


@contextlib.contextmanager
def span(name: str):
    """A host span, kept while a traced window records (else no cost but
    the check)."""
    if _spans is None:
        yield
        return
    s = time.perf_counter()
    try:
        yield
    finally:
        _spans.append((name, s, time.perf_counter()))


class Traced:
    """What :func:`traced` leaves once its block has ended: times in
    seconds on the trace's clock."""

    def __init__(self):
        self.kernels: List[Tuple[str, float, float]] = []   # name, s, e
        self.device: List[Tuple[float, float]] = []          # s, e
        self.spans: List[Tuple[str, float, float]] = []      # name, s, e
        self.window: Tuple[float, float] = (0.0, 0.0)
        self.host_spans: List[Tuple[str, float, float]] = []  # perf_counter
        self.anchor = 0.0               # perf_counter as the anchor began
        self.anchored = False
        self.offset: Optional[float] = None   # trace clock less perf_counter
        # cat, name, start, end, launch time (None: no launch found)
        self.records: List[Tuple[str, str, float, float, Optional[float]]] = []
        self.calls: List[Tuple[str, float, int, Optional[int]]] = []  # name, t, tid, corr
        self.copies: Dict[int, str] = {}  # correlation -> "HtoD", "DtoH", ...
        self.recording: Dict = {"spans": [], "counters": {}}

    def load(self, events: List[Dict]) -> "Traced":
        anchors = []
        launch = {}
        for e in events:
            cat = e.get("cat", "")
            if cat in LAUNCH_CATS and "ts" in e:
                corr = e.get("args", {}).get("correlation")
                t = float(e["ts"]) * 1e-6
                if corr is not None:
                    launch.setdefault(corr, t)
                if cat == "cuda_runtime":
                    self.calls.append((e.get("name", ""), t, e.get("tid", 0), corr))
                    if e.get("name") == ANCHOR and "dur" in e:
                        anchors.append(t)
        for e in events:
            cat = e.get("cat", "")
            if cat not in DEVICE_CATS or "ts" not in e or "dur" not in e:
                continue
            s = float(e["ts"]) * 1e-6
            t = s + float(e["dur"]) * 1e-6
            corr = e.get("args", {}).get("correlation")
            self.device.append((s, t))
            self.records.append((cat, e.get("name", ""), s, t, launch.get(corr)))
            if cat == "kernel":
                self.kernels.append((e["name"], s, t))
            elif cat == "gpu_memcpy":
                # "Memcpy DtoH (Device -> Pageable)"
                self.copies[corr] = (e.get("name", "").split() + ["", ""])[1]
        win = [(s, t) for name, s, t in self.host_spans if name == "window"]
        if anchors and win:
            off = self._offset(anchors, win[0])
            self.anchored, self.offset = True, off
            for name, s, t in self.host_spans:
                if name == "window":
                    self.window = (s + off, t + off)
                else:
                    self.spans.append((name, s + off, t + off))
        elif self.device:
            # no anchor in the trace: the window is the device's first to
            # last interval, and gaps go unnamed
            self.window = (min(s for s, _ in self.device),
                           max(t for _, t in self.device))
        return self

    def _offset(self, anchors: List[float], window: Tuple[float, float]) -> float:
        """The trace's clock less ``perf_counter``: of the synchronizes in
        the trace, the one that puts the most device time inside the
        window is the one made as the profile started."""
        total = sum(t - s for s, t in record.union(self.device))

        def outside(off):
            return total - record.busy_within(self.device, window[0] + off,
                                              window[1] + off)
        return min((a - self.anchor for a in anchors), key=outside)


@contextlib.contextmanager
def traced(device, on: bool = True):
    """Profile the block where ``on``, with the program's recorder on
    inside it (else yield ``None``: the recorder stays off); the result's
    fields are filled when the block ends."""
    global _spans
    if not on:
        yield None
        return
    import torch
    from fgs_nerf_tpu_torch.utils import profiling

    out = Traced()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out.anchor = time.perf_counter()
        torch.cuda.synchronize(device)
        _spans = out.host_spans
        profiling.enable()
        try:
            yield out
        finally:
            _spans = None
            out.recording = profiling.export()
            profiling.disable()
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out.load(json.load(f)["traceEvents"])
    finally:
        os.remove(path)
