"""A configuration, a traffic mix, a cell, a per-layer metric and a kernel
count added as new files (and new entries of BENCHMARK.json) are found
and run by the harness, with no file of portbench/ edited; a metric of a
quantity that has a reader (`mfu.<cell kind>`) needs only its entry."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import common


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and "_cache" not in p.parts}


def test_new_files_are_found_and_run(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(common.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    before = digest(bench)

    cfg = common.load_json(bench / "configs" / "esrgan_x4.json")
    cfg["name"] = "esrgan_tiny"
    cfg["model"].update(num_feat=8, num_block=2, num_grow_ch=4)
    cfg["assumed"]["init"]["out_gain"] = 0.05
    (bench / "configs" / "esrgan_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_frames.json").write_text(json.dumps(
        {"kind": "photo_frames", "height": 24, "width": 32, "channels": 3,
         "octaves": [[8, 0.5], [2, 0.5]], "pool": 2}))
    (bench / "workloads" / "esrgan_tiny.tiny_frames.json").write_text(
        json.dumps({"config": "esrgan_tiny", "traffic": "tiny_frames",
                    "driver": "tiled_staged", "why": "a test cell",
                    "entry": {"tile": [12, 8], "halo": 2, "tail_batch": 3},
                    "sample": 1, "trace_units": 2,
                    "limits": {"rms_err": 1.0, "max_err": 10.0}}))
    (bench / "counts" / "tiny_kernel.py").write_text(
        "def per_frame():\n    return 7\n")
    (bench / "metrics" / "frames_seen.tiny.py").write_text(
        "from portbench.counts import tiny_kernel\n\n\n"
        "def read(ctx):\n"
        "    return ctx.window_units * tiny_kernel.per_frame()\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "esrgan_tiny", "source": "a test",
                         "file": "portbench/configs/esrgan_tiny.json",
                         "reduced": ["num_block"], "why": "a test"})
    b["workloads"].append({"name": "esrgan_tiny.tiny_frames",
                           "config": "esrgan_tiny", "traffic": "tiny_frames",
                           "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if "workloads" in m and m["name"] == "infer_mp_s":
            m["workloads"].append("esrgan_tiny.tiny_frames")
    b["per_layer"].append({"name": "frames_seen.tiny", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "infer_mp_s",
                           "workloads": ["esrgan_tiny.tiny_frames"]})
    b["per_layer"].append({"name": "mfu.tiny", "unit": "%",
                           "better": "higher", "source": "host_clock",
                           "layer": "whole model step", "moves": "infer_mp_s",
                           "workloads": ["esrgan_tiny.tiny_frames"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    code = (
        "import json, sys; sys.path[:0] = [%r, %r]\n"
        "from portbench import common, run\n"
        "assert str(common.BENCH_DIR) == %r, common.BENCH_DIR\n"
        "run.set_cache_dirs()\n"
        "cell = common.cell_files('esrgan_tiny.tiny_frames')\n"
        "out = [run.run_cell(cell, 12345, 0.3, t, device='cpu')"
        " for t in (False, True)]\n"
        "print(json.dumps(out))\n"
        % (str(tmp_path), str(common.ROOT), str(bench)))
    env = dict(os.environ, SRTPU_NO_TB="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(plain["metrics"]) == {"infer_mp_s", "setup_s"}
    assert plain["correct"] and traced["correct"]
    assert traced["metrics"]["frames_seen.tiny"]["value"] == \
        7 * (traced["attempted"] - 2)
    assert traced["metrics"]["mfu.tiny"]["value"] > 0
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
