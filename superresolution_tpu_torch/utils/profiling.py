"""Tracing: the program's spans, torch.profiler capture, a finiteness check.

Counterpart of superresolution_tpu/utils/profiling.py (`trace`,
`finite_check`; the spans are the port's own). `span(name)` marks a
layer boundary of the program (the hybrid's stages, the tilers' gather
and scatter, the Trainer step's parts). With no recorder installed it
is free: one global read, and the same shared null context every call.
Inside `record()` each span opened on the recording thread is kept in
memory with its start and end on time.perf_counter_ns, the span that
encloses it and the root span it belongs to (every span of one request
or step shares its root's id). Nothing is written while recording.
`trace()` records the enclosed block with torch.profiler and its spans,
and writes both as Chrome traces on the profiler's clock;
`finite_check` asserts that a dict of tensors is finite.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Mapping

import torch

# the record_function whose start puts the host clock on the trace's
_MARKER = "profiling.clock_marker"

_OFF = contextlib.nullcontext()
_recorder: Recorder | None = None


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int   # 0 while the span is open
    parent: int   # index of the enclosing span in Recorder.spans; -1: a root
    root: int     # index of the root span (the request's or step's id)


class _Open:
    """One span of a recorder, opened on entry and closed on exit."""

    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name, self.index = rec, name, -1

    def __enter__(self):
        rec = self.rec
        parent = rec._open[-1] if rec._open else -1
        self.index = i = len(rec.spans)
        root = rec.spans[parent].root if parent >= 0 else i
        rec.spans.append(Span(self.name, time.perf_counter_ns(), 0, parent,
                              root))
        rec._open.append(i)
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec.spans[self.index].end_ns = time.perf_counter_ns()
        rec._open.pop()
        return False


class Recorder:
    """The spans opened on the thread that installed it, in the order
    they opened. Spans opened on other threads (the autograd engine's,
    a loader's pool) are dropped."""

    def __init__(self):
        self.spans: list[Span] = []
        self.thread = threading.get_ident()
        self._open: list[int] = []

    def span(self, name: str):
        if threading.get_ident() != self.thread:
            return _OFF
        return _Open(self, name)


def span(name: str):
    """A context manager around one layer of the program: recorded under
    `record()`, a shared null context otherwise."""
    rec = _recorder
    if rec is None:
        return _OFF
    return rec.span(name)


@contextlib.contextmanager
def record():
    """Install a Recorder for the enclosed block and yield it."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a span recorder is already installed")
    rec = _recorder = Recorder()
    try:
        yield rec
    finally:
        _recorder = None


def _chrome_spans(rec: Recorder, offset_us: float) -> list[dict]:
    """The recorder's closed spans as Chrome trace events ("X", category
    program_span), moved onto a trace's clock by offset_us (the trace's
    time of a host instant less that instant on perf_counter)."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s.name,
             "ts": s.start_ns / 1e3 + offset_us,
             "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
             "tid": rec.thread, "args": {"index": i, "parent": s.parent,
                                         "root": s.root}}
            for i, s in enumerate(rec.spans) if s.end_ns]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block and record its spans; writes
    log_dir/trace.json (torch.profiler's Chrome trace: the host's ops
    and, where a GPU is present, the card's) and log_dir/spans.json (the
    spans as Chrome events on that trace's clock, placed through a
    marker whose host time is read just before it opens)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, \
            record() as rec:
        for _ in range(2):  # the first opens late: the profiler sets up
            mark_ns = time.perf_counter_ns()
            with torch.profiler.record_function(_MARKER):
                pass
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mark_us = max(float(ev["ts"]) for ev in events
                  if ev.get("name") == _MARKER)
    offset_us = mark_us - mark_ns / 1e3
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"traceEvents": _chrome_spans(rec, offset_us)}, f)


def finite_check(tree: Mapping[str, torch.Tensor], name: str = "tree"
                 ) -> None:
    """Raise FloatingPointError naming the first entry of a (nested)
    dict of tensors that holds a NaN or Inf; reads each back to the host,
    so use it under debug only."""
    for key, leaf in tree.items():
        path = f"{name}['{key}']"
        if isinstance(leaf, Mapping):
            finite_check(leaf, path)
        elif not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            raise FloatingPointError(f"non-finite values in {path}")
