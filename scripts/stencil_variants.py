"""Time variants of the port's two stencil kernels on one GPU: B3
(conv_last_kernel, ops/csrc/stream_kernels.cu) and kernel 17
(blur_kernel, ops/csrc/extra_kernels.cu).

Each variant is the kernel's source (with conv_engine.cuh, which it
includes) under a few text edits, built by nvcc into its own library
beside the port's own build and called through the same C entry point.
Every variant is checked against the plain version.

B3's variants are timed with CUDA events at the ESRGAN tail's
[8, 1504, 1024, 64] -> 3, beside F.conv2d (cuDNN) on the same operands.
They answer what holds the kernel back:
  no_output    the output columns' work skipped (behind a test the data
               never passes, so the partials stay live): the cost of the
               running sums and the stores
  no_gemm      the row GEMM skipped the same way: the partials are zeros
  stream_only  both: the rows streamed through the ring and nothing else
  nbuf2        a ring of 2 row buffers (1 row in flight) in place of 3
  nbuf5        a ring of 5 row buffers (4 rows in flight)
  three_blocks three blocks an SM (at most 85 registers)
  one_block    one block an SM in place of two
  band16       16 output rows a work unit in place of 64
  band256      256 output rows a work unit

Kernel 17's variants are timed in bf16 at phase 36's four geometries
(chip_smoke.BLUR_CASES): the kernel's mean device time a launch under
torch.profiler over 50 launches and the CUDA-event time a call over 200
back-to-back calls of _build.blur (the host's work included), beside the
depthwise F.conv2d's. They answer which of its forms earn their code:
  taps_scalar  every map through the scalar tap form (one 2- or 4-byte
               shared-memory load a tap and element) in place of the
               row form (C 1) and the vector form (C % 8 == 0)
  no_vec       element-wise staging and guarded element stores in place
               of 16-byte cp.async and 16-byte stores
  scalar_all   both
  uncached     the launcher reading the SM count and raising the kernel's
               shared-memory limit on every call (as before they were
               kept for the process): the host cost of those calls

Usage (one GPU, nvcc as for the port's build), from the repo's root:
  python -m scripts.stencil_variants [variant ...]
Prints the card, each variant's registers and spills, and one line a
kernel (B3) or geometry (17) with the milliseconds of `main` (the
sources as they are), each variant and the library call, and each
variant's max |err| / max |plain| (large for the variants that skip
work).
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import blur as bl
from superresolution_tpu_torch.ops import phase_tail as pt
from superresolution_tpu_torch.utils.conv_engine_variants import (
    rel_err,
    time_ms,
    with_library,
)

NEVER = "a.plant == 0x7fff"      # no check plants this
OUTPUT = "    if (tid < ncols) {"
GEMM = "      if (ks < ksteps) {"
NBUF = "constexpr int NBUF = 3;"
TAPS = ("  const int taps =\n"
        "      a.cc == 1 ? TAPS_ROW : (a.cc % V == 0 ? TAPS_VEC : TAPS_SCALAR);")
VEC = "  a.vec = a.cc == C ? lc % V == 0 : (a.cc % V == 0 && C % V == 0);"
B3 = "stream_kernels.cu"
BLUR = "extra_kernels.cu"
# name: (source, [(old, new), ...])
VARIANTS = {
    "no_output": (B3, [(OUTPUT, f"    if (tid < ncols && {NEVER}) {{")]),
    "no_gemm": (B3, [(GEMM, f"      if (ks < ksteps && {NEVER}) {{")]),
    "stream_only": (B3, [(OUTPUT, f"    if (tid < ncols && {NEVER}) {{"),
                         (GEMM, f"      if (ks < ksteps && {NEVER}) {{")]),
    "nbuf2": (B3, [(NBUF, "constexpr int NBUF = 2;")]),
    "nbuf5": (B3, [(NBUF, "constexpr int NBUF = 5;")]),
    "three_blocks": (B3, [("__launch_bounds__(THREADS, 2)",
                           "__launch_bounds__(THREADS, 3)")]),
    "one_block": (B3, [("sms * per_sm", "sms")]),
    "band16": (B3, [("constexpr int BAND = 64;", "constexpr int BAND = 16;")]),
    "band256": (B3, [("constexpr int BAND = 64;",
                      "constexpr int BAND = 256;")]),
    "taps_scalar": (BLUR, [(TAPS, "  const int taps = TAPS_SCALAR;")]),
    "no_vec": (BLUR, [(VEC, "  a.vec = 0;")]),
    "scalar_all": (BLUR, [(TAPS, "  const int taps = TAPS_SCALAR;"),
                          (VEC, "  a.vec = 0;")]),
    "uncached": (BLUR, [
        ("ce::allow_smem<blur_kernel<T, K, TAPS>>(bytes);",
         "cudaFuncSetAttribute(blur_kernel<T, K, TAPS>, "
         "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);"),
        ("  const cudaError_t e = ce::sm_count(&sms);",
         "  int dev = 0;\n  cudaGetDevice(&dev);\n  const cudaError_t e = "
         "cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);")]),
}
ENTRY = {B3: "stream_conv_last", BLUR: "extra_blur"}
KERNEL = {B3: "conv_last_kernel", BLUR: "blur_kernel"}
SHAPE = (8, 1504, 1024, 64)
BLUR_CASES = (("hybrid_256_balanced", (4, 256, 256, 1), "balanced"),
              ("hybrid_512_balanced", (4, 512, 512, 1), "balanced"),
              ("hybrid_512_light", (4, 512, 512, 1), "light"),
              ("c64_strong", (8, 128, 128, 64), "strong"))


def usage(report: str, kernel: str) -> str:
    """`kernel`'s registers and spills, one item an instantiation."""
    out, lines = [], report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(rf"Compiling entry function '\S*?{kernel}(\S*?)'",
                      line)
        if k:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info).group(1)
            spill = re.search(r"(\d+) bytes spill stores", info).group(1)
            out.append(f"{k.group(1)} {regs}r/{spill}s")
    return " ".join(out)


def build(name: str, workdir: Path) -> tuple[ctypes.CDLL, str]:
    """The variant's library and its ptxas usage."""
    source, edits = VARIANTS[name]
    d = workdir / name
    d.mkdir()
    shutil.copy(_build.SRC_DIR / "conv_engine.cuh", d)
    s = (_build.SRC_DIR / source).read_text()
    for old, new in edits:
        if old not in s:
            raise ValueError(f"{name}: {old!r} not in {source}")
        s = s.replace(old, new)
    (d / source).write_text(s)
    obj, so = str(d / "k.o"), str(d / "lib.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                           str(d / source), "-o", obj],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    subprocess.run([_build._nvcc(), "-shared", "-o", so, obj], check=True)
    lib = ctypes.CDLL(so)
    main = _build.library()
    fn = ENTRY[source]
    getattr(lib, fn).argtypes = getattr(main, fn).argtypes
    getattr(lib, fn).restype = getattr(main, fn).restype
    lib.sr_error_string = main.sr_error_string  # in sr_kernels.cu
    return lib, usage(proc.stderr, KERNEL[source])


def launch_device_ms(fn, calls: int = 50) -> float:
    """The mean device time of fn's kernels a call (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.count) / 1e3


def time_b3(libs: dict, gen: torch.Generator) -> None:
    bf = torch.bfloat16
    y = F.leaky_relu(torch.randn(SHAPE, generator=gen) * 0.5, 0.2).to(
        "cuda", bf)
    w = (torch.randn((3, 3, SHAPE[-1], 3), generator=gen)
         * (2 / (9 * SHAPE[-1])) ** 0.5).to("cuda", bf)
    bias = (0.5 * torch.randn(3, generator=gen)).cuda()
    ref = pt.conv_last_phase_reference(y.float(), w.float(), bias)
    yn, wo = y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    out = torch.empty((*SHAPE[:3], 3), dtype=bf, device="cuda")
    line = ["b3"]
    for name, lib in libs.items():
        out.fill_(float("nan"))

        def launch():
            _build.conv_last(y, w, bias, out)

        with_library(lib, launch)
        ms = with_library(lib, lambda: time_ms(launch, 10))
        line.append(f"{name} {ms:.4f} ms ({rel_err(out, ref):.1e})")
    bb = bias.to(bf)
    ms = time_ms(lambda: F.conv2d(yn, wo, bb, padding=1), 10)
    line.append(f"cudnn {ms:.4f} ms")
    print(" | ".join(line), flush=True)


def time_blur(libs: dict, gen: torch.Generator) -> None:
    for tag, shape, mode in BLUR_CASES:
        size, norm = bl._MODES[mode]
        x = torch.rand(shape, generator=gen).to("cuda", torch.bfloat16)
        ref = bl.anti_checkerboard(x.float(), mode)
        out = torch.empty_like(x)
        line = [tag]
        for name, lib in libs.items():
            out.fill_(float("nan"))

            def launch():
                _build.blur(x, size, norm, out)

            with_library(lib, launch)
            ms = with_library(lib, lambda: launch_device_ms(launch))
            host = with_library(lib, lambda: time_ms(launch, 200))
            line.append(f"{name} {ms:.5f} ms, host {host:.5f} "
                        f"({rel_err(out, ref):.1e})")
        k = torch.as_tensor(bl.binomial_kernel(size, norm), device="cuda")
        kk = k.to(torch.bfloat16).expand(shape[-1], 1, size, size)
        xn = x.permute(0, 3, 1, 2)
        def lib_call():
            return F.conv2d(xn, kk, padding=size // 2, groups=shape[-1])

        line.append(f"depthwise F.conv2d {launch_device_ms(lib_call):.5f} "
                    f"ms, host {time_ms(lib_call, 200):.5f}")
        print(" | ".join(line), flush=True)


def main(names: list[str]) -> int:
    if not torch.cuda.is_available():
        print("stencil_variants: no CUDA device", file=sys.stderr)
        return 1
    names = names or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu="
                           "name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _, _, report = _build.build()
    for source, kernel in KERNEL.items():
        print("main", source,
              usage(report, kernel) or "(cached build: no ptxas report)")
    gen = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = {B3: {"main": _build.library()},
                BLUR: {"main": _build.library()}}
        with ThreadPoolExecutor(len(names)) as pool:  # nvcc in parallel
            built = list(pool.map(lambda n: build(n, Path(tmp)), names))
        for name, (lib, use) in zip(names, built):
            libs[VARIANTS[name][0]][name] = lib
            print(name, use, flush=True)
        with torch.inference_mode():
            if len(libs[B3]) > 1:
                time_b3(libs[B3], gen)
            if len(libs[BLUR]) > 1:
                time_blur(libs[BLUR], gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
