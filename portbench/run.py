"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is portbench/workloads/<cell>.json; it names its configuration
(configs/), its traffic mix (traffic/) and the driver (drivers/) that
runs the port's entry point. A run: set-up (the port's kernel library
built or found, weights and inputs made from the seed, every shape the
cell uses warmed up), then a closed loop of units (frames, patches or
optimizer steps) for --seconds, then with --trace 1 a short profiled
stretch; then the port's state is freed and the outputs are compared
with the plain reference (portbench/reference/). The last line of
standard output is one JSON object: correct, attempted, failed,
metrics, device, breakdown (--trace 1) and the compared numbers with
their limits (`checks`, last).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import sys
import time
import traceback
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import common  # noqa: E402

CACHE_DIR = common.BENCH_DIR / "_cache"


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so only a checkout's first run builds (the port's own nvcc library
    lives in superresolution_tpu_torch/_build/, inside it too)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_compute")):
        os.environ[var] = str(CACHE_DIR / sub)
    # the Trainer's TensorBoard writer is left out of set-up: the window
    # logs nothing (JSONL logs are kept)
    os.environ.setdefault("SRTPU_NO_TB", "1")
    os.environ.setdefault("USE_FLAX", "0")


class Context:
    """What a driver is given and what the metric readers read."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        self.config = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.setup_s = None
        self.window_s = None
        self.window_units = 0
        self.units = 0
        self.work = 0.0
        self.latencies: list = []
        self.stretch = None        # tracing.Trace of the profiled units
        self.stretch_units = 0
        self.extra: dict = {}      # driver readings for the readers
        self.driver = None
        self.recording = None      # the Trace being recorded, if any

    def span(self, name: str):
        """A benchmark span around a call into a layer: recorded while the
        stretch is traced, free otherwise."""
        if self.recording is None:
            return contextlib.nullcontext()
        return self.recording.span(name)


def run_window(ctx: Context, drv, seconds: float, sample: int,
               rng: random.Random, kept: list, sync):
    """Units until `seconds` have passed; returns (units, seconds,
    failed). Keeps a uniform sample of `sample` unit records (reservoir
    sampling). A unit's finiteness flag stays on the card until the
    window has closed."""
    import torch

    bad = None
    failed = 0
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        try:
            work, record, finite = drv.run_unit(ctx.units)
        except Exception:  # a unit that raises counts as failed
            traceback.print_exc(file=sys.stderr)
            failed += 1
            work, record, finite = 0.0, None, None
        if drv.sync_each:
            sync()
            ctx.latencies.append(time.perf_counter() - ts)
        if finite is not None:
            f = (~finite).int()
            bad = f if bad is None else bad + f
        ctx.work += work
        if record is not None:
            if len(kept) < sample:
                kept.append(record)
            else:
                j = rng.randrange(i + 1)
                if j < sample:
                    kept[j] = record
        ctx.units += 1
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    if bad is not None:
        failed += int(torch.as_tensor(bad).item())
    return i, elapsed, failed


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", driver_override=None) -> dict:
    """One run of `cell`; returns the result object. device='cpu' and
    driver_override serve the harness's own tests only."""
    import torch

    from portbench import tracing

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    ctx = Context(cell, seed, seconds, trace, device)
    t0 = time.perf_counter()
    drv_mod = driver_override or common.load_module(
        common.BENCH_DIR / "drivers" / f"{cell['driver']}.py")
    drv = drv_mod.Driver(ctx)
    ctx.driver = drv
    drv.setup()
    sync()
    ctx.setup_s = time.perf_counter() - t0

    kept: list = []
    rng = random.Random(common.subseed(seed, "sample"))
    sample = int(cell.get("sample", 1))
    n, ctx.window_s, failed = run_window(ctx, drv, seconds, sample, rng,
                                         kept, sync)
    ctx.window_units = attempted = n
    if trace:
        drv.tracing = True
        units_before = ctx.units
        flags = []
        with tracing.profile(device) as tr:
            ctx.recording = tr
            for _ in range(int(cell["trace_units"])):
                with ctx.span("unit"):
                    work, record, finite = drv.run_unit(ctx.units)
                if drv.sync_each:
                    sync()
                flags.append(finite)
                ctx.units += 1
                attempted += 1
        failed += sum(int(not bool(f)) for f in flags if f is not None)
        drv.tracing = False
        ctx.recording = None
        ctx.stretch = tr
        ctx.stretch_units = ctx.units - units_before
        drv.after_trace()

    peak = (torch.cuda.max_memory_allocated() if device == "cuda"
            else 0)
    device_info = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                 else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    if trace:
        device_info["busy_s"] = ctx.stretch.busy_s
        device_info["window_s"] = ctx.stretch.window_s

    bench = common.benchmark()
    e2e, layer = common.cell_metrics(bench, cell["name"])
    metrics = {}
    for m in (layer if trace else e2e):
        reader = common.load_module(common.reader_path(m["name"]))
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    drv.finish()
    sync()
    # the reference in full float32: no TF32 in cuDNN's convs or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        numbers = drv.check(kept)
    found = common.forbidden_loaded()
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded: {found}")
    limits = cell["limits"]
    checks = {k: {"value": float(numbers[k]), "limit": float(v)}
              for k, v in limits.items()}
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = ctx.stretch.breakdown()
    out["card"] = common.card_line() if device == "cuda" else "cpu"
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()

    import torch

    bench = common.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {entry['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    cell = common.cell_files(args.workload)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']} (failed units: {result['failed']})",
          file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
