"""The benchmark's own tests (run as `python -m pytest portbench/tests`;
the repository's `pytest tests/` does not collect them)."""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# no TensorBoard (and no TensorFlow behind it) in the Trainer's set-up
os.environ.setdefault("SRTPU_NO_TB", "1")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")
