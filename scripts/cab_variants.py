"""Time the forms of kernel 7 (the CAB's LN -> conv -> GELU -> conv) on
one GPU, at the deploy path's three widths.

Variants of the one-launch tensor-core body (ops/csrc/cab_kernels.cu),
each the source under a few text edits, built by nvcc into its own
library beside the port's build and called through the same C entry
point (cab_tc):
  th16_ring   the source as it is: 16 x 16 tiles (8 warps), the packed
              weights streamed through a two-slot cp.async ring in shared
              memory, a slab a tap
  th8_ring    8 x 16 tiles (4 warps): more of conv1 spent on the hidden
              halo (1.41x in place of 1.27x), smaller blocks
  th12_ring   12 x 16 tiles (6 warps): at C 120 and 128 two blocks fit an
              SM with the ring, which 16 rows do not
  th16_l1     each lane reads its weight fragments from device memory
              through L1 (__ldg), no ring (its syncs stay)
  th8_l1, th12_l1  the same at 8 and 12 rows
  th16_ring4  a ring of four slots (three slabs ahead in place of one:
              conv2's taps are short beside an L2 load)
Each is checked against the plain version (max |err| / max |plain|
printed, which must stay within 0.02) and timed with CUDA events
(time_ms, and queued behind a spin: the card alone) beside the port's
own build of kernel 7, the three launches kernel 7 took before
(layernorm_kernel and two conv3x3_kernel, still the body off the route
rule), the plain version and the cuDNN composition (layer_norm, conv,
GELU, conv as PyTorch calls: what SRTPU_XLA_CAB runs), at [1,256,256,96]
(hidden 32), [1,256,256,120] (hidden 40) and [1,256,256,128] with c_real
96 (hidden 32). Registers and spills of each variant's instances come
from nvcc's -Xptxas -v report.

Usage (one GPU, nvcc as for the port's build), from the repo's root:
  python -m scripts.cab_variants [variant ...]
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROWS = "constexpr int TILE_ROWS = 16;"
L1 = [  # the weights read through L1 in place of the ring
    ("const uint2* wb = reinterpret_cast<const uint2*>(slot(tap));",
     "const uint2* wb = a.w1 + (size_t)tap * l.ks1 * NF1 * 32;"),
    ("const uint2* wb = reinterpret_cast<const uint2*>(slot(s));",
     "const uint2* wb = a.w2 + ((size_t)tap * l.ks2 * l.nf2 + j0) * 32;"),
    ("const uint2* wp = wb + (ks * NJ2 + jj) * 32 + lane;",
     "const uint2* wp = wb + (ks * l.nf2 + jj) * 32 + lane;"),
    ("const uint2 bw = *wp;", "const uint2 bw = __ldg(wp);"),
    ("  load_slab(0);\n", ""),
    ("    if (s + SLOTS - 1 < nslab) load_slab(s + SLOTS - 1);\n", ""),
    ("    slot_bytes = s1 > s2 ? s1 : s2;", "    slot_bytes = 0 * (s1 + s2);"),
]
VARIANTS = {
    "th16_ring": [],
    "th8_ring": [(ROWS, "constexpr int TILE_ROWS = 8;")],
    "th12_ring": [(ROWS, "constexpr int TILE_ROWS = 12;")],
    "th16_l1": L1,
    "th8_l1": [(ROWS, "constexpr int TILE_ROWS = 8;"), *L1],
    "th12_l1": [(ROWS, "constexpr int TILE_ROWS = 12;"), *L1],
    "th16_ring4": [("constexpr int SLOTS = 2;", "constexpr int SLOTS = 4;")],
}
SHAPES = (("c96", 96, 32, None), ("c120", 120, 40, None),
          ("c128_creal96", 128, 32, 96))
SIDE = 256


def usage(report: str) -> str:
    """Each cab_tc_kernel instance's registers and spills, by conv1's
    fragments (hidden / 8)."""
    out, lines = [], report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(r"Compiling entry function '\S*?cab_tc_kernel"
                      r"ILi(\d+)ELi(\d+)E", line)
        if k:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info).group(1)
            spill = re.search(r"(\d+) bytes spill stores", info).group(1)
            out.append(f"nf{k.group(2)} {regs}r/{spill}s")
    return " ".join(out)


def build(name: str, edits, workdir: Path):
    """The variant's library and its ptxas usage."""
    from superresolution_tpu_torch.ops import _build

    d = workdir / name
    d.mkdir()
    shutil.copy(_build.SRC_DIR / "conv_engine.cuh", d)
    src = (_build.SRC_DIR / "cab_kernels.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{name}: {old!r} not in cab_kernels.cu")
        src = src.replace(old, new)
    (d / "cab_kernels.cu").write_text(src)
    so = d / "lib.so"
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-o", str(so), str(d / "cab_kernels.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{p.stderr}")
    lib = ctypes.CDLL(str(so))
    main = _build.library()
    for fn in ("cab_tc", "cab_tc_smem"):
        getattr(lib, fn).argtypes = getattr(main, fn).argtypes
        getattr(lib, fn).restype = getattr(main, fn).restype
    lib.sr_error_string = main.sr_error_string  # in sr_kernels.cu
    return lib, usage(p.stderr)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref).abs().max() / ref.abs().max())


def with_library(lib, fn):
    from superresolution_tpu_torch.ops import _build

    real = _build.library
    _build.library = lambda: lib
    try:
        return fn()
    finally:
        _build.library = real


def main(names: list[str]) -> int:
    import chip_smoke as cs
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import hab

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = names or list(VARIANTS)
    _build.build()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build(n, VARIANTS[n], Path(tmp)), names)))
        gen = torch.Generator().manual_seed(cs.SEED + 11)
        card = cs.nvidia_smi()
        for tag, c, mid, cr in SHAPES:
            w = hab.cab_mma_weights(
                cs.lane_padded_cab_weights(gen, cr, c) if cr
                else cs.cab_check_weights(gen, c, mid))
            x = cs.rand(gen, 1, SIDE, SIDE, cr or c, dtype=torch.bfloat16)
            if cr:
                x = cs.pad_lanes(x, [3], c)
            cw = cs.cudnn_cab_weights(w)
            ref = hab.fused_cab_convs_reference(x.float(), w, c_real=cr)
            row = {"shape": tag, "card": card}
            for name, (lib, ptx) in built.items():
                out = torch.empty_like(x)

                def run(lib=lib, out=out):
                    return with_library(lib, lambda: _build.cab_tc(
                        x, w, out, None, cr))
                run()
                row[name] = {"err": rel_err(out, ref),
                             "ms": cs.time_ms(run, 20),
                             "queued_ms": cs.queued_ms(run, 20),
                             "smem": lib.cab_tc_smem(c, mid), "ptxas": ptx}
            row["kernel7"] = {
                "err": rel_err(hab.fused_cab_convs(x, w, c_real=cr), ref),
                "ms": cs.time_ms(lambda: hab.fused_cab_convs(
                    x, w, c_real=cr), 20)}
            row["three_launches"] = {
                "err": rel_err(cs.cab_three_launches(x, w, cr), ref),
                "ms": cs.time_ms(lambda: cs.cab_three_launches(x, w, cr),
                                 20)}
            row["plain_ms"] = cs.time_ms(
                lambda: hab.fused_cab_convs_reference(x, w, c_real=cr), 5)
            row["cudnn"] = {"err": rel_err(cs.cudnn_cab(x, cw, cr), ref),
                            "ms": cs.time_ms(lambda: cs.cudnn_cab(x, cw, cr),
                                             20)}
            row["bound"] = cs.cab_bound(SIDE * SIDE, c, mid)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
