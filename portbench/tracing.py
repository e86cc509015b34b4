"""The traced stretch: torch.profiler (CUDA activity only) over the last
few units of a `--trace 1` run, reduced to device intervals, host spans
and the breakdown the result line carries.

Only the card's activity is profiled (kernels, copies and the runtime
calls that launch them), and the benchmark's own host spans
(Trace.span, around the calls into each layer) are kept with the host
clock, placed on the trace's timeline through the first launch of the
stretch, a marker kernel whose runtime call the trace records. The
profiler still costs the host some 10-15 us a launch, so a host-bound
stretch runs slower than the untraced window (the hybrid's patches:
43-49 ms against 31-36 ms); the idle share is read against the untraced
window's time a unit (metrics/idle_share.*).

Device time is the union of the kernel, copy and set intervals (not a
sum of self times: two streams can overlap). Idle gaps are labelled by
the innermost benchmark span the host was in when the work that ends
the gap was launched (its kernel starts a few microseconds later).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (name, start_us, dur_us)
    copies: list = field(default_factory=list)    # memcpy / memset
    spans: list = field(default_factory=list)     # (name, start_us, end_us)
    start_us: float = 0.0
    end_us: float = 0.0

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span on the host clock (moved onto the trace's clock when
        the profile is read)."""
        t0 = _now_us()
        try:
            yield
        finally:
            self.spans.append((name, t0, _now_us()))

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def intervals(self) -> list:
        out = []
        for _, s, d in sorted(self.kernels + self.copies,
                              key=lambda e: e[1]):
            s, e = max(s, self.start_us), min(s + d, self.end_us)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e6

    def kernel_seconds(self, match) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name `match`
        accepts."""
        t, n = 0.0, 0
        for name, _, d in self.kernels:
            if match(name):
                t += d
                n += 1
        return t / 1e6, n

    def span_at(self, t_us: float) -> str:
        best = None
        for name, s, e in self.spans:
            if s <= t_us <= e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "outside any span"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for name, _, d in self.kernels + self.copies:
            by_name[name] = by_name.get(name, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        iv = self.intervals()
        edges = ([self.start_us] + [e for _, e in iv],
                 [s for s, _ in iv] + [self.end_us])
        for a, b in zip(*edges):
            if b > a:
                gaps.append((f"{self.span_at(b - 5.0)} (gap ending at "
                             f"{(b - self.start_us) / 1e3:.3f} ms)",
                             (b - a) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


@contextlib.contextmanager
def profile(device: str = "cuda"):
    """Profile the enclosed stretch; yields a Trace, filled on exit. The
    chrome trace goes to a temporary file under TMPDIR and is deleted
    once read."""
    tr = Trace()
    cuda = device == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        marker_us = None
        if cuda:
            torch.cuda.synchronize()
            marker_us = _now_us()
            torch.cuda._sleep(100)  # the marker launch
        start = _now_us()
        yield tr
        if cuda:
            torch.cuda.synchronize()
        end = _now_us()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    launches = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        name, ts = ev.get("name", ""), float(ev["ts"])
        dur = float(ev.get("dur", 0.0))
        if cat == "kernel":
            tr.kernels.append((name, ts, dur))
        elif cat in DEVICE_CATS:
            tr.copies.append((name, ts, dur))
        elif cat == "cuda_runtime" and "Launch" in name:
            launches.append(ts)
    # host clock -> trace clock: the marker's launch is the first the
    # trace holds
    offset = (min(launches) - marker_us) if launches and marker_us else 0.0
    tr.spans = [(n, s + offset, e + offset) for n, s, e in tr.spans]
    tr.start_us, tr.end_us = start + offset, end + offset
    return tr
