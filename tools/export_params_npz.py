#!/usr/bin/env python
"""Export the committed quality checkpoint for the PyTorch port.

The port (superresolution_tpu_torch/) reads no orbax checkpoint and
imports no JAX, so this JAX-side tool restores
assets/quality/final_weights/best with the JAX package's own
load_params_for_inference (EMA params when present, as the reference's
quality anchor uses them) and writes

    <out>/params.npz         every leaf as f32, keyed by its '/'-joined
                             tree path (e.g. body/RRDB_0/FusedDenseBlock_0/
                             Conv_0/Conv_0/kernel)
    <out>/model_config.json  a copy of the checkpoint's architecture

The port's train/checkpoint.load_params_for_inference turns that npz into
its own state dict through models/convert.py.

Usage (needs JAX and orbax):
    python tools/export_params_npz.py [--ckpt DIR] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {'a/b/c': f32 array}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten(v, path))
        else:
            flat[path] = np.asarray(v, dtype=np.float32)
    return flat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=os.path.join(
        ROOT, "assets", "quality", "final_weights", "best"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "assets", "quality", "port"))
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from superresolution_tpu.train.checkpoint import (
        load_params_for_inference)

    params, cfg = load_params_for_inference(args.ckpt, with_config=True)
    if set(params) == {"params"}:
        params = params["params"]
    flat = flatten(params)
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "params.npz"), **flat)
    with open(os.path.join(args.out, "model_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
        f.write("\n")
    n = sum(a.size for a in flat.values())
    print(json.dumps({"leaves": len(flat), "parameters": int(n),
                      "out": os.path.relpath(args.out, ROOT)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
