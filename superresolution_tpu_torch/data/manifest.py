"""JSON split manifests.

The port's own copy of superresolution_tpu/data/manifest.py (it imports
nothing of the JAX package): the same schema, scan and splits.

Schema matches the reference (reference: scripts/Modello_2.py:38-52 and
Backup/scripts/Modello_2.py:10-63): a list of
{"patch_id": str, "hubble_path": str, "ground_path": str} entries, with
hubble=HR and ground=LR. `prepare_splits` supports both reference modes:
'overfit' (one pair copied into train/val/test — the reference's sanity-
check methodology) and 'split' (seeded shuffle, 90/10 train/val, test=val).
"""

from __future__ import annotations

import json
import os
import random
from typing import Sequence


def load_manifest(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError(f"manifest {path} is not a list")
    return data


def write_manifest(entries: Sequence[dict], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(list(entries), f, indent=2)


def scan_pairs(root: str, hr_name: str = "hubble.tiff",
               lr_name: str = "observatory.tiff") -> list[dict]:
    """Scan `root` for pair_* directories with both files present
    (the step-4 output contract, reference:
    scripts/Dataset_step4_normalization.py:181-184)."""
    entries = []
    for d in sorted(os.listdir(root)):
        pdir = os.path.join(root, d)
        hr = os.path.join(pdir, hr_name)
        lr = os.path.join(pdir, lr_name)
        if os.path.isdir(pdir) and os.path.exists(hr) and os.path.exists(lr):
            entries.append({"patch_id": d, "hubble_path": hr, "ground_path": lr})
    return entries


def prepare_splits(root: str, out_dir: str, mode: str = "split",
                   val_frac: float = 0.1, seed: int = 42) -> dict[str, str]:
    """Write train/val/test manifests. Returns {'train': path, ...}."""
    entries = scan_pairs(root)
    if not entries:
        raise FileNotFoundError(f"no pairs under {root}")
    os.makedirs(out_dir, exist_ok=True)
    if mode == "overfit":
        # one pair everywhere (reference scripts/Modello_2.py:27-52)
        one = [entries[0]]
        splits = {"train": one, "val": one, "test": one}
    elif mode == "split":
        rnd = random.Random(seed)
        shuffled = entries[:]
        rnd.shuffle(shuffled)
        n_val = max(1, int(len(shuffled) * val_frac))
        val = shuffled[:n_val]
        train = shuffled[n_val:]
        splits = {"train": train, "val": val, "test": val}
    else:
        raise ValueError(f"unknown split mode {mode!r}")
    paths = {}
    for name, data in splits.items():
        p = os.path.join(out_dir, f"{name}.json")
        write_manifest(data, p)
        paths[name] = p
    return paths
