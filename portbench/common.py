"""What every part of the harness shares: the repository's paths, the
files a cell is made of, seeds, statistics and the card's identity."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# top-level module names that must never be loaded: the JAX stack and
# the JAX package the port was made from (compared whole: the port's
# own name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "superresolution_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell `name`, with its configuration and traffic mix read from
    the files the names point at."""
    cell = load_json(bench_dir / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_data"] = load_json(bench_dir / "configs"
                                    / f"{cell['config']}.json")
    cell["traffic_data"] = load_json(bench_dir / "traffic"
                                     / f"{cell['traffic']}.json")
    return cell


def reader_path(metric: str, bench_dir: Path = BENCH_DIR) -> Path:
    """The reader of a metric: metrics/<name>.py where there is one, else
    the reader of its quantity, metrics/<stem>.py (the name up to its
    first dot: `mfu.train` and `mfu.infer` are read by metrics/mfu.py)."""
    own = bench_dir / "metrics" / f"{metric}.py"
    return own if own.exists() else (bench_dir / "metrics"
                                     / f"{metric.split('.', 1)[0]}.py")


def load_module(path: Path, name: str | None = None):
    """Import a file of the harness by its path (metric readers and
    drivers have dots in their names, so no import statement finds
    them)."""
    spec = importlib.util.spec_from_file_location(
        name or f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that cell reports: those
    that list it under `workloads`, or, without that key, every cell
    (end-to-end) or every cell that reports the metric it moves
    (per-layer)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    return e2e, layer


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (weights, inputs, sampling) of a run."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def percentile(values: list, q: float) -> float:
    """The q-th percentile, linearly interpolated between order
    statistics (numpy's default)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def forbidden_loaded() -> list[str]:
    top = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN_MODULES))


def card_line() -> str:
    """nvidia-smi's name and power limit of card 0, or why not read."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return (r.stdout or r.stderr).strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"
