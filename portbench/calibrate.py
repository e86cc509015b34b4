"""The readings a cell's correctness limits are set from, on the card, at
the cell's own sizes, all seeds in one process:

    python portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--units N]

For each seed: the program's set-up and N units of the cell's own load
(default: the sample a run compares), then the numbers a run compares
(the lower readings). For each control seed, the same records against
the control: the reference computed with float8 operands put in the
program's place (reference/ops.FP8), and for a training cell the planted
fault of a step over half of its batch (the mean over the rest), and
two witnesses of what rounding alone reads: the reference computed
plainly
at the configuration's bfloat16 (reference/ops.BF16) against the float32
reference, and the float32 reference against one in float64, beside
the program against float64. A step that leaves the state unchanged
reads 1 by the leaf measure and needs no run. One JSON line per seed and
reading; the benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import common, run  # noqa: E402


def readings(cell: dict, seed: int, units: int, control: bool,
             device: str = "cuda") -> dict:
    import torch

    from portbench.reference.compare import image_gap, worst
    from portbench.reference.ops import BF16, F32, FP8

    ctx = run.Context(cell, seed, 0.0, False, device)
    drv = common.load_module(common.BENCH_DIR / "drivers"
                             / f"{cell['driver']}.py").Driver(ctx)
    ctx.driver = drv
    t0 = time.perf_counter()
    drv.setup()
    records = []
    for i in range(units):
        _, rec, _ = drv.run_unit(i)
        if rec is not None:
            records.append(rec)
    if device == "cuda":
        torch.cuda.synchronize()
    drv.finish()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"cell": cell["name"], "seed": seed, "units": units}
    with torch.no_grad():
        out["program"] = drv.check(records)
    if control:
        if hasattr(drv, "reference_steps"):
            ref = drv.reference_steps(F32)
            out["control_fp8"] = drv.gaps(drv.reference_steps(FP8), ref)
            out["fault_half_batch"] = drv.gaps(
                drv.reference_steps(F32, half_batch=True), ref)
            out["witness_bf16"] = drv.gaps(drv.reference_steps(BF16), ref)
            r64 = drv.reference_steps(F32, dtype=torch.float64)
            out["witness_f32_vs_f64"] = drv.gaps(ref, r64)
            out["program_vs_f64"] = drv.gaps(
                (drv.losses, drv.g1, drv.delta), r64)
        else:
            with torch.no_grad():
                out["control_fp8"] = worst([
                    image_gap(drv.reference(k, FP8), drv.reference(k, F32))
                    for k, _ in records])
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--units", type=int, default=0)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = common.cell_files(args.workload)
    units = args.units or int(cell.get("sample", 1))
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), units, int(s) in control)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
