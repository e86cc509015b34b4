"""Time variants of the conv engine's tensor-core body on one GPU.

Each variant is the engine's sources (ops/csrc/conv_engine.cuh and the
two policy files, subpixel_kernels.cu and pack_kernels.cu) with a few
text edits, built by nvcc into its own library beside the port's own
build and called through the same C entry points. Every variant is
checked against the plain version and timed with CUDA events at the
main shapes of kernels 15 (EDSR's two x2 stages, ESPCN's head) and 18
(64 -> 192 and 32 -> 160 at B1's tile), beside F.conv2d (cuDNN) on the
same operands.

The variants answer what holds the body back:
  no_store     the tile's stores skipped (behind a test the data never
               passes, so the products stay live): the cost of the stores
  no_epilogue  the whole epilogue skipped the same way: the main loop alone
  word_stores  kernel 15's 16-byte stores from the threads in place of
               its bulk copies (kernel 18 has only bulk copies)
  b_ahead      B fragments loaded a k-step ahead at every width (at 96
               columns this spills, which ptxas reports)
  two_blocks   two blocks an SM at every width

Usage (one GPU, nvcc as for the port's build):
  python -m superresolution_tpu_torch.utils.conv_engine_variants \
      [variant ...]
Prints the card, each variant's registers and spills, and one line per
shape with the milliseconds of `main` (the sources as they are), each
variant and cuDNN, and each variant's max |err| / max |plain|.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import pairconv as pc
from superresolution_tpu_torch.ops import subpixel as sp

PUT = "  a.template tc_put<BN>(out_s, BSTR, b, ty0, tx0, n0, tid);"
NEVER = "a.plant == 0x7fff"      # no check plants this
VARIANTS = {
    "no_store": [("conv_engine.cuh", PUT, f"  if ({NEVER}) {PUT.strip()}")],
    "no_epilogue": [
        ("conv_engine.cuh", "  // accumulator (f, j, q): tile row",
         f"  if ({NEVER}) {{\n  // accumulator (f, j, q): tile row"),
        ("conv_engine.cuh", PUT, PUT + "\n  }")],
    "word_stores": [
        ("subpixel_kernels.cu", "    if (vec == 8 && plant != PLANT_SWAP_IJ &&",
         "    if (false && vec == 8 && plant != PLANT_SWAP_IJ &&")],
    "b_ahead": [("conv_engine.cuh",
                 "static constexpr bool B_AHEAD = MIN_BLOCKS == 2;",
                 "static constexpr bool B_AHEAD = true;")],
    "two_blocks": [("conv_engine.cuh",
                    "static constexpr int MIN_BLOCKS = BN <= 96 ? 3 : 2;",
                    "static constexpr int MIN_BLOCKS = 2;")],
}
SOURCES = ("conv_engine.cuh", "subpixel_kernels.cu", "pack_kernels.cu")


def usage(report: str) -> str:
    """The tensor-core kernels' registers and spills, one item each."""
    out, lines = [], report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(r"Compiling entry function '\S*?conv_tc_kernel\S*?"
                      r"(Subpixel|PackConv)\S*?Li(\d+)E", line)
        if k:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info).group(1)
            spill = re.search(r"(\d+) bytes spill stores", info).group(1)
            out.append(f"{k.group(1)}:{k.group(2)} {regs}r/{spill}s")
    return " ".join(out)


def build(name: str, edits, workdir: Path) -> tuple[ctypes.CDLL, str]:
    """The variant's library and its ptxas usage."""
    d = workdir / name
    d.mkdir()
    for f in SOURCES:
        s = (_build.SRC_DIR / f).read_text()
        for target, old, new in edits:
            if target == f:
                if old not in s:
                    raise ValueError(f"{name}: {old!r} not in {f}")
                s = s.replace(old, new)
        (d / f).write_text(s)
    objs, procs = [], []
    for f in SOURCES[1:]:
        objs.append(str(d / f"{f}.o"))
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(d / f), "-o",
             objs[-1]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    report = ""
    for p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        report += err
    so = str(d / "lib.so")
    subprocess.run([_build._nvcc(), "-shared", "-o", so, *objs], check=True)
    lib = ctypes.CDLL(so)
    main = _build.library()
    for fn in ("subpixel_conv3x3_d2s", "extra_pack_conv"):
        getattr(lib, fn).argtypes = getattr(main, fn).argtypes
        getattr(lib, fn).restype = getattr(main, fn).restype
    lib.sr_error_string = main.sr_error_string  # in sr_kernels.cu
    return lib, usage(report)


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref).abs().max() / ref.abs().max())


def with_library(lib, fn):
    real = _build.library
    _build.library = lambda: lib
    try:
        return fn()
    finally:
        _build.library = real


def cases(gen: torch.Generator):
    """(tag, launch(out), fresh output, plain result, cuDNN call, iters)."""
    bf = torch.bfloat16
    for tag, b, h, cin, cout, r in (("k15_edsr1", 8, 288, 64, 64, 2),
                                    ("k15_edsr2", 8, 576, 64, 64, 2),
                                    ("k15_espcn", 8, 288, 32, 1, 4)):
        x = torch.randn((b, cin, h, h), generator=gen).to(
            "cuda", bf).contiguous(memory_format=torch.channels_last)
        w = (torch.randn((cout * r * r, cin, 3, 3), generator=gen)
             / (9 * cin) ** 0.5).to("cuda", bf)
        bias = (0.5 * torch.randn(cout * r * r, generator=gen)).to("cuda", bf)
        wk, bk = sp.kmajor_weights(w, bias, r, bf)
        ref = sp.reference_conv3x3_depth_to_space(
            x.float(), w.float(), bias.float(), r).permute(0, 2, 3, 1)
        yield (tag, lambda out, x=x, wk=wk, bk=bk, r=r: _build.conv3x3_d2s(
            x, wk, bk, r, out, True),
            lambda b=b, h=h, r=r, cout=cout: torch.empty(
                (b, h * r, h * r, cout), dtype=bf, device="cuda"), ref,
            lambda x=x, w=w, bias=bias: F.conv2d(x, w, bias, padding=1),
            3 if tag == "k15_edsr2" else 10)
    b, h, width, p = 24, 376, 256, 2
    for c, n in ((64, 192), (32, 160)):
        x = torch.randn((b, h, width, c), generator=gen).cuda()
        xp = pc.pack_input(x, p).to(bf)
        w = (torch.randn((3, 3, c, n), generator=gen) / (9 * c) ** 0.5).cuda()
        bias = (0.5 * torch.randn(n, generator=gen)).cuda()
        wk = pc.kmajor_weights(w, bf)
        ref = pc.pack_conv3x3_reference(xp.float(), w.to(bf).float(), bias,
                                        p, width)
        xn = x.to(bf).permute(0, 3, 1, 2)
        wo = w.to(bf).permute(3, 2, 0, 1).contiguous()
        yield (f"k18_c{c}_n{n}", lambda out, xp=xp, wk=wk, bias=bias:
               _build.pack_conv(xp, wk, bias, out, p, width, False, True),
               lambda xp=xp, n=n: torch.empty(
                   (*xp.shape[:3], p * n), dtype=bf, device="cuda"), ref,
               lambda xn=xn, wo=wo, bias=bias: F.conv2d(
                   xn, wo, bias.to(bf), padding=1), 5)


def main(names: list[str]) -> int:
    if not torch.cuda.is_available():
        print("conv_engine_variants: no CUDA device", file=sys.stderr)
        return 1
    names = names or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu="
                           "name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _, _, report = _build.build()
    libs = {"main": _build.library()}
    print("main", usage(report) or "(cached build: no ptxas report)")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for name in names:
            libs[name], use = build(name, VARIANTS[name], Path(tmp))
            print(name, use, flush=True)
        gen = torch.Generator().manual_seed(0)
        with torch.inference_mode():
            for tag, launch, fresh, ref, library, iters in cases(gen):
                line = [tag]
                for name, lib in libs.items():
                    out = fresh()
                    with_library(lib, lambda: launch(out))
                    ms = with_library(lib, lambda: time_ms(
                        lambda: launch(out), iters))
                    line.append(f"{name} {ms:.4f} ms ({rel_err(out, ref):.1e})")
                line.append(f"cudnn {time_ms(library, iters):.4f} ms")
                print(" | ".join(line), flush=True)
                del ref
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
