"""Profiling: the program's span recorder and a ``torch.profiler`` trace.

The one recorder of the program's own spans and counters.  The program
marks its layer boundaries with :func:`span` and its useful-work counts
with :func:`count`:

    with span("forward"):
        ...
    count("head_rows", n)

The recorder is off unless :func:`enable` (or :func:`trace_steps`) turned
it on.  Off, ``span`` hands out one shared object that does nothing and
``count`` returns at once: a module-global check each, nothing more.
On, each span keeps ``SpanRecord(name, id, parent, tid, start, end)``
in memory, with ``time.perf_counter`` seconds; a span opened on a thread
with no span open takes as its parent the innermost span open on the
thread that turned the recorder on (autograd runs a CUDA backward, and
``torch.utils.checkpoint``'s recompute, on a worker thread of its own).
A counter sums ints and 0-d device tensors; the tensors are kept as they
are and read once, by :func:`export`, so recording never waits on the
device.  :func:`export` returns the spans and counters and clears them.

Spans of the program: ``train_step`` > ``forward`` (> ``shade``; on
the sorted fine path also ``head_count``, the host read of the head's
live rows), ``loss``, ``backward`` (> ``shade`` where the head is
recomputed), ``metrics``, ``dp_reduce``, ``tv``, ``adam``
(``train/trainer.py``, ``models/sdf_voxel.py``); ``stage_step``,
``batch``, ``rung``, ``flush``, ``validate``, ``checkpoint``
(``train_stage``);
``render_view`` > ``rays``, ``to_host``, ``score``, ``save``
(``eval/render.py``).  Counters: ``head_live_rows`` and ``head_rows``,
the shading head's live rows and the rows it computes (``forward``; the
sorted fine head computes its stream's live prefix, the other heads
every slot).

:func:`trace_steps` (port of ``fgs_nerf_tpu/utils/profiling.py``) is the
operator's view: a Chrome trace (Perfetto) of the steps run inside it,
with the recorder on and the program's spans written into the trace as
host events (``cat`` "program") on the trace's clock:

    with trace_steps("/tmp/tb") as trace:
        ... run steps ...
    print(trace.path)
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

# the record_function that places perf_counter on a trace's clock
ANCHOR = "fgs_program_anchor"


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    tid: int          # the thread's OS id (``threading.get_native_id``)
    start: float      # ``time.perf_counter`` seconds
    end: float


class _Off:
    """The span handed out while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recording:
    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, list] = {}
        self.stacks: Dict[int, List[int]] = {}   # thread ident -> open ids
        self.owner = threading.get_ident()
        self.ids = itertools.count()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "stack", "start")

    def __init__(self, rec: _Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.stack = rec.stacks.setdefault(threading.get_ident(), [])
        outer = self.stack or rec.stacks.get(rec.owner) or (None,)
        self.parent = outer[-1]
        self.id = next(rec.ids)
        self.stack.append(self.id)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self.stack.pop()
        self.rec.spans.append(SpanRecord(self.name, self.id, self.parent,
                                         threading.get_native_id(),
                                         self.start, end))
        return False


_rec: Optional[_Recording] = None


def span(name: str):
    """A context manager around one layer's work (no cost but the check
    while the recorder is off)."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Span(rec, name)


def count(name: str, value) -> None:
    """Add ``value``, an int or a 0-d tensor left on its device, to the
    counter ``name``."""
    rec = _rec
    if rec is None:
        return
    rec.counters.setdefault(name, []).append(value)


def recording() -> bool:
    """Whether the recorder is on (for counts that cost work to make)."""
    return _rec is not None


def enable() -> None:
    """Turn the recorder on with an empty recording; this thread's open
    spans parent those of threads that have none open."""
    global _rec
    _rec = _Recording()


def disable() -> None:
    global _rec
    _rec = None


def _total(values) -> int:
    host = [v for v in values if not isinstance(v, torch.Tensor)]
    dev = [v.reshape(()) for v in values if isinstance(v, torch.Tensor)]
    return int(sum(host)) + (int(torch.stack(dev).sum()) if dev else 0)


def export() -> Dict:
    """The recording so far, which is cleared: ``spans`` (``SpanRecord``
    in the order they ended) and ``counters`` (name -> int; device values
    are read here).  Empty while the recorder is off."""
    rec = _rec
    if rec is None:
        return {"spans": [], "counters": {}}
    spans, counters = rec.spans, rec.counters
    rec.spans, rec.counters = [], {}
    return {"spans": spans,
            "counters": {k: _total(v) for k, v in counters.items()}}


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


def _write_spans(path: str, spans: List[SpanRecord], anchor: float) -> None:
    """Add ``spans`` to the Chrome trace at ``path`` as host events on its
    clock: ``anchor`` is ``perf_counter`` as the ``ANCHOR`` event began."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    ts = next(float(e["ts"]) for e in events
              if e.get("name") == ANCHOR and e.get("ph") == "X")
    off_us = ts - anchor * 1e6
    pid = os.getpid()
    events += [{"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                "tid": s.tid, "ts": s.start * 1e6 + off_us,
                "dur": (s.end - s.start) * 1e6,
                "args": {"id": s.id, "parent": s.parent}} for s in spans]
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace_steps(logdir: str, device="cuda"):
    """Record CPU and, on a CUDA device, CUDA activity of the enclosed
    steps with the span recorder on; writes ``trace_<pid>_<n>.json``
    (Chrome / Perfetto) under ``logdir``, the program's spans in it.  A
    CUDA device on a machine with no card raises: the trace never falls
    back to the CPU."""
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
        anchor = time.perf_counter()
        with torch.profiler.record_function(ANCHOR):
            pass
        enable()
        try:
            yield trace
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            spans = export()["spans"]
            disable()
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    trace.path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(trace.path)
    _write_spans(trace.path, spans, anchor)
