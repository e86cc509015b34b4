"""Metrics logging: JSONL always; TensorBoard when it imports.

Counterpart of superresolution_tpu/train/logging.py:29-70; as there, a
set SRTPU_NO_TB keeps TensorBoard off, and images (the preview strips)
go to TensorBoard only.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard and not os.environ.get("SRTPU_NO_TB"):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: JSONL only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=log_dir)

    def scalars(self, step: int, values: dict[str, float],
                prefix: str = "") -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in values.items():
            name = f"{prefix}{k}" if prefix else k
            rec[name] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(name, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def image(self, step: int, name: str, img: np.ndarray) -> None:
        """img: HWC float [0,1]."""
        if self._tb is not None:
            self._tb.add_image(name, np.transpose(
                np.asarray(img, np.float32), (2, 0, 1)), step)

    def close(self) -> None:
        if not self._jsonl.closed:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None
