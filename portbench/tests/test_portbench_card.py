"""Each cell, run by its command for a short window on the card, prints
a correct result line; skipped without a card."""

import json
import subprocess
import sys

import pytest

from portbench import common


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  common.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, str(common.BENCH_DIR / "run.py"), "--workload",
         name, "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=common.ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
