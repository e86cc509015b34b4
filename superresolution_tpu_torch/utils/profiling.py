"""Tracing and step timing: torch.profiler capture and per-step counters.

Counterpart of superresolution_tpu/utils/profiling.py. `trace()` records
the enclosed block with torch.profiler (the host and, where present, the
card) and writes a Chrome trace (viewable in Perfetto or
chrome://tracing); `StepTimer` keeps streaming step-time and throughput
statistics; `finite_check` asserts that a dict of tensors is finite.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Mapping

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; writes log_dir/trace.json (Chrome
    format). CUDA activity is recorded when a GPU is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Streaming per-step wall-time and throughput stats (the first
    `warmup` steps are not counted)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._sum = 0.0
        self._min = float("inf")
        self._last = None

    def tick(self) -> None:
        self._last = time.perf_counter()

    def tock(self) -> float:
        dt = time.perf_counter() - self._last
        self._n += 1
        if self._n > self.warmup:
            self._sum += dt
            self._min = min(self._min, dt)
        return dt

    @property
    def mean(self) -> float:
        counted = self._n - self.warmup
        return self._sum / counted if counted > 0 else float("nan")

    @property
    def best(self) -> float:
        return self._min

    def throughput(self, items_per_step: float) -> float:
        return items_per_step / self.mean if self.mean > 0 else 0.0


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
