"""The program's own spans (superresolution_tpu_torch/utils/profiling.span:
the hybrid's stages, the tilers' gather and scatter, the Trainer step's
parts) on the card's trace, for the span readers (metrics/stage1_ms.py,
stage2_ms, stage2_launches, tiler_ms, fwd_ms, bwd_ms, opt_ms,
dispatch_gap_ms).

tracing.profile, which a `--trace 1` run's stretch goes through, keeps
neither the program's spans nor which launch made which kernel. So the
first span reader of a traced run profiles a second stretch: the cell's
`trace_units` units again, right after the first, with the driver as
the window and the first stretch left it and the program's recorder
(profiling.record) installed around the units alone. The other span
readers read the same stretch, kept on the run's context. Its units are
not compared, counted as attempted or timed by any other reader: the
span metrics come after every other metric of their cells in
BENCHMARK.json's list, so every other reader has read by then.

Each kernel, copy and set is attributed to the innermost program span
open on the recording thread when the runtime call that launched it
began (the trace's `correlation` ties the two), so a kernel the
autograd engine's thread launched falls in the span the main thread
waits in (train.backward). A gap in the card's work is attributed to
the launch of the work that ends it. The host clock goes onto the
trace's through a marker launch (tracing.py's method), the second of
two, so that nothing the profiler sets up on its first launch is in it.

Where the program has no recorder (a tree older than its spans) or the
run has no card, the readers read nothing.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

from portbench.tracing import DEVICE_CATS

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MIN_DEVICE_OVER_HOST = 0.75
TRIES = 3


@dataclass
class SpanTrace:
    """A profiled stretch of `units` units: the program's spans and the
    card's work, on the trace's clock (us)."""
    names: list = field(default_factory=list)
    starts: list = field(default_factory=list)
    ends: list = field(default_factory=list)
    parents: list = field(default_factory=list)
    # (start_us, dur_us, is_kernel, launch_us or None)
    work: list = field(default_factory=list)
    start_us: float = 0.0
    end_us: float = 0.0
    units: int = 1
    _own: list | None = field(default=None, repr=False)

    def owner(self, t_us: float | None) -> int:
        """The index of the innermost span open at t_us, or -1. Spans of
        one thread nest, and the recorder lists them as they opened: the
        last to open before t_us holds it, or one of its ancestors."""
        if t_us is None:
            return -1
        i = bisect.bisect_right(self.starts, t_us) - 1
        while i >= 0 and self.ends[i] < t_us:
            i = self.parents[i]
        return i

    def enclosing(self, i: int, name: str) -> int:
        """The innermost span named `name` that is span i or holds it, or
        -1."""
        while i >= 0 and self.names[i] != name:
            i = self.parents[i]
        return i

    def _owners(self) -> list:
        """The owner of each work item's launch."""
        if self._own is None:
            self._own = [self.owner(w[3]) for w in self.work]
        return self._own

    def _items_under(self, name: str):
        """The work launched under `name`; None where no span of that name
        opened in the stretch."""
        if name not in self.names:
            return None
        return [w for w, o in zip(self.work, self._owners())
                if self.enclosing(o, name) >= 0]

    def device_ms(self, name: str) -> float | None:
        """Device ms a unit of the kernels, copies and sets launched under
        `name` (a sum of their durations)."""
        items = self._items_under(name)
        if items is None:
            return None
        return sum(w[1] for w in items) / 1e3 / self.units

    def launches(self, name: str) -> float | None:
        """Kernels a unit launched under `name`."""
        items = self._items_under(name)
        if items is None:
            return None
        return sum(1 for w in items if w[2]) / self.units

    def gaps(self) -> list:
        """(idle us, the index of the work that ends the gap) of every gap
        in the card's work inside the stretch."""
        out, busy_end = [], self.start_us
        for j in sorted(range(len(self.work)),
                        key=lambda k: self.work[k][0]):
            s, d = self.work[j][0], self.work[j][1]
            s, e = max(s, self.start_us), min(s + d, self.end_us)
            if e <= s:
                continue
            if s > busy_end:
                out.append((s - busy_end, j))
            busy_end = max(busy_end, e)
        return out

    def gap_ms(self, name: str) -> float | None:
        """Device-idle ms a unit in gaps whose ending work was launched
        under `name`, each from the opening of that span on (the card's
        wait for the host while it was inside it, not before: a batch's
        fetch, the harness's loop)."""
        if name not in self.names:
            return None
        owners = self._owners()
        total = 0.0
        for g, j in self.gaps():
            r = self.enclosing(owners[j], name)
            if r >= 0:
                total += max(0.0, min(g, self.work[j][0] - self.starts[r]))
        return total / 1e3 / self.units

    def device_over_host(self) -> float | None:
        """The card's span of the work inside the stretch (first start to
        last end) over the host's span of it: near 1, less the host's
        time before its first launch; far below 1 where the trace's
        device clock ran off the host's."""
        inside = [(s, s + d) for s, d, _, _ in self.work
                  if s >= self.start_us]
        if not inside or self.end_us <= self.start_us:
            return None
        span = max(e for _, e in inside) - min(s for s, _ in inside)
        return span / (self.end_us - self.start_us)

    def covered(self) -> float | None:
        """The share of the kernels' device time launched under some span."""
        owners = self._owners()
        total = sum(w[1] for w in self.work if w[2])
        if not total:
            return None
        return sum(w[1] for w, o in zip(self.work, owners)
                   if w[2] and o >= 0) / total

    def labelled_gaps(self, top: int = 10) -> list:
        """The longest gaps, each labelled by the innermost span its
        ending work was launched in: [label, idle s]."""
        owners = self._owners()
        out = []
        for g, j in sorted(self.gaps(), key=lambda g: -g[0])[:top]:
            name = self.names[owners[j]] if owners[j] >= 0 else \
                "outside any span"
            at = (self.work[j][0] - self.start_us) / 1e3
            out.append([f"{name} (gap ending at {at:.3f} ms)", g / 1e6])
        return out


def from_events(events: list, spans: list, offset_us: float,
                start_us: float, end_us: float, units: int) -> SpanTrace:
    """A SpanTrace from a Chrome trace's events and a recorder's closed
    spans (profiling.Span, perf_counter ns), the spans moved onto the
    trace's clock by offset_us; start_us and end_us on the trace's
    clock."""
    launch_at = {}
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("ph") == "X" and ev.get("cat") in LAUNCH_CATS and \
                "correlation" in args:
            launch_at[args["correlation"]] = float(ev["ts"])
    work = []
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            work.append((float(ev["ts"]), float(ev.get("dur", 0.0)),
                         ev["cat"] == "kernel", launch_at.get(corr)))
    return SpanTrace(
        names=[s.name for s in spans],
        starts=[s.start_ns / 1e3 + offset_us for s in spans],
        ends=[s.end_ns / 1e3 + offset_us for s in spans],
        parents=[s.parent for s in spans], work=work, start_us=start_us,
        end_us=end_us, units=units)


def _profiled_units(ctx, record) -> SpanTrace:
    """The cell's trace_units units, profiled on the card (CUDA activity
    only, as tracing.profile), with `record()` around the units."""
    import torch

    drv, n = ctx.driver, int(ctx.cell["trace_units"])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            mark_ns = time.perf_counter_ns()
            torch.cuda._sleep(100)  # a marker launch
        torch.cuda.synchronize()
        start_ns = time.perf_counter_ns()
        with record() as rec:
            for _ in range(n):
                drv.run_unit(ctx.units)
                if drv.sync_each:
                    torch.cuda.synchronize()
                ctx.units += 1
        torch.cuda.synchronize()
        end_ns = time.perf_counter_ns()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    marks = sorted(float(ev["ts"]) for ev in events
                   if ev.get("ph") == "X" and ev.get("cat") in LAUNCH_CATS
                   and "Launch" in ev.get("name", ""))[:2]
    offset = marks[-1] - mark_ns / 1e3
    return from_events(events, rec.spans, offset, start_ns / 1e3 + offset,
                       end_ns / 1e3 + offset, n)


def stretch(ctx) -> SpanTrace | None:
    """The run's second stretch with the program's spans, profiled on the
    first call and kept on ctx (its share of kernel time under a span,
    its device-over-host span and its longest gaps, each labelled by its
    ending work's launch, go to standard error); None without a card,
    outside a traced run, or where the program has no span recorder. A
    stretch whose card work spans under MIN_DEVICE_OVER_HOST of the
    host's time is profiled again, up to TRIES times in all: one profile
    in some eighty on the card read every kernel at half its time."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = None
        if ctx.device == "cuda" and ctx.stretch is not None:
            from superresolution_tpu_torch.utils import profiling

            record = getattr(profiling, "record", None)
            for _ in range(TRIES if record is not None else 0):
                st = ctx.program_spans = _profiled_units(ctx, record)
                ratio = st.device_over_host()
                print(json.dumps({"program_spans": {
                    "kernel_time_covered": st.covered(),
                    "device_over_host": ratio,
                    "idle_gaps": st.labelled_gaps()}}), file=sys.stderr)
                if ratio is None or ratio >= MIN_DEVICE_OVER_HOST:
                    break
    return ctx.program_spans
