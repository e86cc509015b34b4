"""Time variants of B1 and B2 on the conv engine's tensor-core body, and
compare the frames of two trees, on one GPU.

Variants. Each is the sources of B1 and B2 (ops/csrc/dense_kernels.cu,
tail_kernels.cu, with conv_engine.cuh, which both include) under a few
text edits, built by nvcc into its own library beside the port's own
build and called through the same C entry points (dense_conv,
tail_up_conv). Each is checked against the plain version (max |err| /
max |plain| printed) and timed with CUDA events at the main path's
shapes: B1 at [24,376,256,64] (its five launches, and conv 1 and conv 4
alone), B2 at z1 [8,376,256,256] (both launches, and each alone):
  warps_2x2     the 2 x 2 warp grid also at N = 32 (conv 1-4 of B1), in
                place of 4 x 1: a k-step's 8 products against 4 A and
                1 B fragment loads, not 2 and 2
  warps_4x1_n16 the 4 x 1 grid at 16 columns too
  split_epilogue  every finish value made, in place in the
                accumulators, before the first store to the tile, in
                place of each stored as it is made (so B1's residual
                loads need not wait behind shared stores they might
                alias)
  th16          tiles of 16 rows in place of 8 (twice the products a
                staged halo row and weight slab; the halo tile of C +
                4g = 192 channels then takes 130 KB, one block an SM)
  two_blocks    two blocks an SM at every width (three up to 96 columns)
  b_ahead       B fragments loaded a k-step ahead at every width
  no_store      the tile's stores skipped (behind a test the data never
                passes, so the products stay live): a floor
  no_epilogue   the whole epilogue skipped the same way: the main loop
                alone, a floor
  first_co64    kernel 4's conv_first (the direct body under DenseConv,
                x_raw [24,376,256,3]) with 64 output channels a block,
                as the body picks by cout, in place of 32
  first_ck8     the direct body's every chunk of CK = 8 channels
                multiplied out, past cin too, as before conv_first
  first_parent  both: conv_first as the direct body first ran it
  first_no_put  DenseConv's direct-body stores skipped (behind a test the
                values never pass, so the sums stay live): conv_first's
                floor without them
Kernel 4's conv_first and kernel 5's trunk_conv (the tensor-core body,
+ head) are timed alone, and B1's conv 1 in f32 (the direct body) at
hybrid_astro's [4,128,128,64].

A/B (--ab PARENT): runs the measurements below in the parent tree (a
checkout of the commit before, e.g. unpacked by `git archive` under
outputs/) and in this one, each in its own process, in the order parent,
this, this, parent, and prints one line a metric with the four values:
B1 and B2 at the main shapes and their plain versions; kernels 15 and 18
at their main shapes; the ESRGAN 2K frame, its trunk and its tail (host
clock); the hybrid and h200-class frames and the ESPCN and EDSR x4
upscale frames, from each tree's chip_smoke.py (host clock, and the
device ms of the profiled frame where it prints one).

Usage (one GPU, nvcc as for the port's build), from the repo's root:
  python -m scripts.dense_tail_variants [variant ...]
  python -m scripts.dense_tail_variants --ab outputs/parent
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

SHAPE = "static constexpr int WARPS_N = BN == 32 ? 1 : 2;"
PUT = "  a.template tc_put<BN>(out_s, BSTR, b, ty0, tx0, n0, tid);"
NEVER = "a.cout() == 0x7fff"      # no launch has that many columns
# split_epilogue: every finish value made in place in the accumulators
# before the first store to the tile, then the stores
STORE = """        bf16* row = out_s + (ty * TW + tx) * BSTR;
        const float2 v =
            a.finish(b, ty0 + ty, tx0 + tx, n0 + n, acc[f][j][2 * h] + b0,
                     acc[f][j][2 * h + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(row + n) =
            __floats2bfloat162_rn(v.x, v.y);
"""
SPLIT = ("""        const float2 v =
            a.finish(b, ty0 + ty, tx0 + tx, n0 + n, acc[f][j][2 * h] + b0,
                     acc[f][j][2 * h + 1] + b1);
        acc[f][j][2 * h] = v.x, acc[f][j][2 * h + 1] = v.y;
""", """#pragma unroll
  for (int j = 0; j < S::NF; ++j)
#pragma unroll
    for (int f = 0; f < S::MF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(
            out_s + ((wm * S::MF + f) * TW + (lane >> 2) + 8 * h) * BSTR +
            wn * S::NF * 8 + j * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[f][j][2 * h], acc[f][j][2 * h + 1]);
""")
FENCE = "  fence_async_smem();\n  __syncthreads();\n"
FIRST_CO = ("dense_kernels.cu",
            "conv_engine::direct::launch<DenseConv<bf16>, false, 32>(",
            "conv_engine::direct::launch<DenseConv<bf16>, false>(")
FIRST_CK = ("conv_engine.cuh", "for (int ci = 0; ci < ck; ++ci) {",
            "for (int ci = 0; ci < CK; ++ci) {")
DIRECT_PUT = ("    conv_engine::store(out + pix(b, y, xx) * ostride + "
              "out_off + o, v);")
VARIANTS = {
    "warps_2x2": [("conv_engine.cuh", SHAPE,
                   "static constexpr int WARPS_N = 2;")],
    "warps_4x1_n16": [("conv_engine.cuh", SHAPE,
                       "static constexpr int WARPS_N = BN <= 32 ? 1 : 2;")],
    "split_epilogue": [("conv_engine.cuh", STORE, SPLIT[0]),
                       ("conv_engine.cuh", FENCE + PUT,
                        SPLIT[1] + FENCE + PUT)],
    "th16": [("conv_engine.cuh",
              "constexpr int TH = 8;             // output rows per block",
              "constexpr int TH = 16;            // output rows per block")],
    "two_blocks": [("conv_engine.cuh",
                    "static constexpr int MIN_BLOCKS = BN <= 96 ? 3 : 2;",
                    "static constexpr int MIN_BLOCKS = 2;")],
    "b_ahead": [("conv_engine.cuh",
                 "static constexpr bool B_AHEAD = MIN_BLOCKS == 2;",
                 "static constexpr bool B_AHEAD = true;")],
    "no_store": [("conv_engine.cuh", PUT, f"  if ({NEVER}) {PUT.strip()}")],
    "no_epilogue": [
        ("conv_engine.cuh", "  // accumulator (f, j, q): tile row",
         f"  if ({NEVER}) {{\n  // accumulator (f, j, q): tile row"),
        ("conv_engine.cuh", PUT, PUT + "\n  }")],
    "first_co64": [FIRST_CO],
    "first_ck8": [FIRST_CK],
    "first_parent": [FIRST_CO, FIRST_CK],
    "first_no_put": [("dense_kernels.cu", DIRECT_PUT,
                      f"    if (v != 1.2345e30f) return;\n{DIRECT_PUT}")],
}
SOURCES = ("conv_engine.cuh", "dense_kernels.cu", "tail_kernels.cu")
ENTRIES = ("dense_conv", "dense_first_conv", "tail_up_conv")


def usage(report: str) -> str:
    """The tensor-core kernels' and DenseConv's direct instances'
    registers and spills, one item each."""
    out, lines = [], report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(r"Compiling entry function '\S*?(conv_tc_kernel|"
                      r"conv_kernel)\S*?(DenseConv|PhaseUp)(I13__nv_bfloat16"
                      r"E|IfE)?\S*?Li(\d+)E", line)
        if k:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info).group(1)
            spill = re.search(r"(\d+) bytes spill stores", info).group(1)
            body = "" if k.group(1) == "conv_tc_kernel" else (
                "direct_f32_" if k.group(3) == "IfE" else "direct_bf16_")
            out.append(f"{body}{k.group(2)}:{k.group(4)} {regs}r/{spill}s")
    return " ".join(out)


def build(name: str, edits, workdir: Path):
    """The variant's library and its ptxas usage."""
    from superresolution_tpu_torch.ops import _build

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
    objs = [str(d / f"{f}.o") for f in SOURCES[1:]]

    def nvcc(f, o):
        return subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                               str(d / f), "-o", o], capture_output=True,
                              text=True)

    with ThreadPoolExecutor(len(objs)) as ex:
        procs = list(ex.map(nvcc, SOURCES[1:], objs))
    for p in procs:
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{p.stderr}")
    so = str(d / "lib.so")
    subprocess.run([_build._nvcc(), "-shared", "-o", so, *objs], check=True)
    lib = ctypes.CDLL(so)
    main = _build.library()
    for fn in ENTRIES:
        getattr(lib, fn).argtypes = getattr(main, fn).argtypes
        getattr(lib, fn).restype = getattr(main, fn).restype
    lib.sr_error_string = main.sr_error_string  # in sr_kernels.cu
    return lib, usage("".join(p.stderr for p in procs))


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
    from superresolution_tpu_torch.ops import _build

    real = _build.library
    _build.library = lambda: lib
    try:
        return fn()
    finally:
        _build.library = real


def cases(gen: torch.Generator):
    """(tag, launch() -> output, plain result, iters) at the main shapes."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import phase_tail as pt

    bf, dev = torch.bfloat16, "cuda"
    b, h, w, c, g = 24, 376, 256, 64, 32
    ks, bs = [], []
    for j in range(5):
        cin, cout = c + j * g, g if j < 4 else c
        ks.append(torch.randn(3, 3, cin, cout, generator=gen)
                  * 2 * (2 / (9 * cin)) ** 0.5)
        bs.append(torch.randn(cout, generator=gen) * 0.5)
    ws = dt.dense_weights(ks, bs, device=dev)
    x = (torch.randn(b, h, w, c, generator=gen) * 0.2).to(dev, bf)
    res = (torch.randn(b, h, w, c, generator=gen) * 0.05).to(dev, bf)
    y = torch.empty(b, h, w, 4 * g, dtype=bf, device=dev)
    wf = [(k.float(), bb) for k, bb in ws]
    wp = torch.empty(y.shape, device=dev)
    ref = dt.fused_dense_block_reference(x.float(), wf, res.float(),
                                         workspace=wp)
    yield ("b1", lambda: dt.fused_dense_block(x, ws, res, workspace=y), ref,
           10)
    for j in (0, 3):
        yield (f"b1_conv{j + 1}", lambda j=j: (_build.dense_conv(
            x, y, j * g, ws[j][0], ws[j][1], y, j * g, lrelu=True), y)[1][
                ..., j * g:(j + 1) * g], wp[..., j * g:(j + 1) * g], 10)
    del ref
    x_raw = (torch.randn(b, h, w, 3, generator=gen) * 0.5).to(dev, bf)
    k4 = [(torch.randn(3, 3, n, c, generator=gen) * 2
           * (2 / (9 * n)) ** 0.5).to(dev, bf) for n in (3, c)]
    b4 = [(torch.randn(c, generator=gen) * 0.1).to(dev) for _ in range(2)]
    hd = torch.empty_like(x)
    yield ("k4_first_conv", lambda: (_build.first_conv(
        x_raw, k4[0], b4[0], hd), hd)[1], dt._conv(
            x_raw.float(), (k4[0].float(), b4[0])), 20)
    yield ("k5_trunk_conv", lambda: (_build.dense_conv(
        x, None, 0, k4[1], b4[1], hd, 0, add=res), hd)[1], dt._conv(
            x.float(), (k4[1].float(), b4[1])) + res.float(), 20)
    del x_raw, hd, x, res, y, wp
    x32 = torch.randn(4, 128, 128, c, generator=gen, device="cpu").to(dev)
    y32 = torch.empty(4, 128, 128, 4 * g, device=dev)
    yield ("b1_f32_conv1", lambda: (_build.dense_conv(
        x32, y32, 0, wf[0][0], wf[0][1], y32, 0, lrelu=True), y32)[1][
            ..., :g], F.leaky_relu(dt._conv(x32, wf[0]), 0.2), 10)
    bt = 8
    z1 = F.leaky_relu(torch.randn(bt, h, w, 4 * c, generator=gen) * 0.3,
                      0.2).to(dev, bf)
    tw = [(torch.randn(3, 3, c, 4 * c, generator=gen)
           * (2 / (9 * c)) ** 0.5).to(dev, bf),
          (torch.randn(4 * c, generator=gen) * 0.5).to(dev),
          (torch.randn(3, 3, c, c, generator=gen)
           * (2 / (9 * c)) ** 0.5).to(dev, bf),
          (torch.randn(c, generator=gen) * 0.5).to(dev)]
    z1p, (wpk, bpk) = pt.to_phase_major(z1), pt.phase_major_up2(*tw[:2])
    ref = pt.up2_hr_reference(z1.float(), tw[0].float(), tw[1],
                              tw[2].float(), tw[3])
    yield ("b2", lambda: pt.up2_hr(z1p, *tw, layout="phase",
                                   up2_phase=(wpk, bpk)), ref, 5)
    t = torch.empty(bt, 2 * h, 2 * w, 4 * c, dtype=bf, device=dev)
    tref = F.leaky_relu(pt._conv_hwio(pt.depth_to_space(z1.float(), 2),
                                      tw[0].float(), tw[1]), 0.2)
    yield ("b2_up2", lambda: (_build.up_conv(z1p, wpk, bpk, t, True), t)[1],
           pt.to_phase_major(tref), 5)
    del tref
    out = torch.empty(bt, 4 * h, 4 * w, c, dtype=bf, device=dev)
    _build.up_conv(z1p, wpk, bpk, t, True)
    yref = F.leaky_relu(pt._conv_hwio(
        pt.depth_to_space(pt.from_phase_major(t).float(), 2), tw[2].float(),
        tw[3]), 0.2)
    yield ("b2_hr", lambda: (_build.up_conv(t, tw[2], tw[3], out, True),
                             out)[1], yref, 5)


def variants(names: list[str]) -> int:
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.runtime import exact_fp32_reference

    exact_fp32_reference()
    names = names or list(VARIANTS)
    print(card(), flush=True)
    _, _, report = _build.build()
    libs = {"main": _build.library()}
    print("main", usage(report) or "(cached build: no ptxas report)")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        with ThreadPoolExecutor(3) as ex:  # two nvcc processes each
            built = list(ex.map(lambda n: build(n, VARIANTS[n], Path(tmp)),
                                names))
        for name, (lib, use) in zip(names, built):
            libs[name] = lib
            print(name, use, flush=True)
        gen = torch.Generator().manual_seed(0)
        with torch.inference_mode():
            for tag, launch, ref, iters in cases(gen):
                line = [tag]
                for name, lib in libs.items():
                    got = with_library(lib, launch)
                    ms = with_library(lib, lambda: time_ms(launch, iters))
                    line.append(f"{name} {ms:.4f} ms "
                                f"({rel_err(got, ref):.1e})")
                print(" | ".join(line), flush=True)
                del ref
                torch.cuda.empty_cache()
    return 0


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu="
                           "name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


# ---- A/B of two trees ------------------------------------------------

def measure() -> int:
    """Run in a tree's root (its modules first on sys.path): prints one
    JSON line of measurements, and chip_smoke.py's frame lines."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from superresolution_tpu_torch.infer.fused_trunk import make_fused_trunk
    from superresolution_tpu_torch.infer.phase_tail import make_phase_tail
    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer_staged)
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import pairconv as pc
    from superresolution_tpu_torch.ops import phase_tail as pt
    from superresolution_tpu_torch.ops import subpixel as sp
    from superresolution_tpu_torch.runtime import exact_fp32_reference

    exact_fp32_reference()
    _build.build()
    _build.library()
    bf, dev = torch.bfloat16, "cuda"
    res = {}
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        ws = cs.dense_check_weights(gen)
        x = (torch.randn(24, 376, 256, 64, generator=gen) * 0.2).to(dev, bf)
        r = (torch.randn(24, 376, 256, 64, generator=gen) * 0.05).to(dev, bf)
        res["b1_ms"] = time_ms(lambda: dt.fused_dense_block(x, ws, r), 10)
        res["b1_plain_ms"] = time_ms(
            lambda: dt.fused_dense_block_reference(x, ws, r), 10)
        del x, r
        z1 = F.leaky_relu(torch.randn(8, 376, 256, 256, generator=gen)
                          * 0.3, 0.2).to(dev, bf)
        tw = [(torch.randn(3, 3, 64, 256, generator=gen) * 0.06).to(dev, bf),
              (torch.randn(256, generator=gen) * 0.02).to(dev),
              (torch.randn(3, 3, 64, 64, generator=gen) * 0.06).to(dev, bf),
              (torch.randn(64, generator=gen) * 0.02).to(dev)]
        if hasattr(pt, "phase_major_up2"):   # the path's form
            z1p, up2p = pt.to_phase_major(z1), pt.phase_major_up2(*tw[:2])
            res["b2_ms"] = time_ms(lambda: pt.up2_hr(
                z1p, *tw, layout="phase", up2_phase=up2p), 5)
            del z1p
        else:
            res["b2_ms"] = time_ms(lambda: pt.up2_hr(z1, *tw), 5)
        res["b2_plain_ms"] = time_ms(lambda: pt.up2_hr_reference(z1, *tw), 5)
        del z1
        torch.cuda.empty_cache()
        for tag, bsz, hw, cin, cout, r_ in (("k15_edsr1", 8, 288, 64, 64, 2),
                                            ("k15_edsr2", 8, 576, 64, 64, 2),
                                            ("k15_espcn", 8, 288, 32, 1, 4)):
            xs = torch.randn((bsz, cin, hw, hw), generator=gen).to(
                dev, bf).contiguous(memory_format=torch.channels_last)
            wt = (torch.randn((cout * r_ * r_, cin, 3, 3), generator=gen)
                  / (9 * cin) ** 0.5).to(dev, bf)
            wk, bk = sp.kmajor_weights(wt, torch.zeros(
                cout * r_ * r_, device=dev, dtype=bf), r_, bf)
            o = torch.empty((bsz, hw * r_, hw * r_, cout), dtype=bf,
                            device=dev)
            res[f"{tag}_ms"] = time_ms(lambda: _build.conv3x3_d2s(
                xs, wk, bk, r_, o, True), 10)
            del xs, o
        for c, n in ((64, 192), (32, 160)):
            xs = torch.randn((24, 376, 256, c), generator=gen).to(dev)
            xp = pc.pack_input(xs, 2).to(bf)
            wk = pc.kmajor_weights((torch.randn((3, 3, c, n), generator=gen)
                                    / (9 * c) ** 0.5).to(dev), bf)
            bias = torch.zeros(n, device=dev)
            o = torch.empty((*xp.shape[:3], 2 * n), dtype=bf, device=dev)
            res[f"k18_c{c}_n{n}_ms"] = time_ms(lambda: _build.pack_conv(
                xp, wk, bias, o, 2, 256, False, True), 10)
            del xs, xp, o
        torch.cuda.empty_cache()
        gen = torch.Generator().manual_seed(cs.SEED)
        model = RRDBNet(scale=4, in_channels=3, out_channels=3, features=64,
                        num_blocks=23, growth=32, upsampler="pixelshuffle",
                        generator=gen).to(bf).eval()
        params = model.state_dict()
        img = torch.rand((cs.H, cs.W, 3), generator=gen).cuda()
        fused = make_fused_trunk(params, model)
        geom = dict(scale=4, tile=cs.TILE, halo=cs.HALO,
                    tail_batch=cs.TAIL_BATCH, h=cs.H, w=cs.W, channels=3)
        runner = make_tiled_infer_staged(lambda t: fused(t.to(bf)),
                                         make_phase_tail(params), **geom)
        run_trunk, run_tail = make_tiled_infer_staged(
            lambda t: fused(t.to(bf)), make_phase_tail(params, clip=False),
            split_stages=True, **geom)
        runner(img)
        res["esrgan_frame_s"] = cs.host_clock(lambda: runner(img))
        res["esrgan_trunk_ms"] = cs.host_clock(lambda: run_trunk(img)) * 1e3
        feats = run_trunk(img)
        res["esrgan_tail_ms"] = cs.host_clock(lambda: run_tail(feats)) * 1e3
        del feats, runner, run_trunk, run_tail, fused, model, params, img
        torch.cuda.empty_cache()
    crd = cs.nvidia_smi()
    print(json.dumps({"ab": res, "card": crd}), flush=True)
    cs.zero_counts()
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    cs.hybrid_path(gen, crd)
    torch.cuda.empty_cache()
    cs.h200_path(torch.Generator().manual_seed(cs.SEED + 4), crd)
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(cs.SEED + 6)
    cs.sr_upscale_path("edsr", gen, crd, 3, 2)
    torch.cuda.empty_cache()
    cs.sr_upscale_path("espcn", gen, crd, 1, 1)
    return 0


FRAME_KEYS = {"hybrid_times": ("frame_ms", "device_ms_per_frame"),
              "h200_times": ("fused_ms",),
              "edsr_upscale_times": ("frame_s", "device_ms_per_frame"),
              "espcn_upscale_times": ("frame_s", "device_ms_per_frame")}


def ab(parent: str) -> int:
    """parent, this, this, parent: one process each; one line a metric."""
    here = str(Path(__file__).resolve().parents[1])
    trees = [("parent", str(Path(parent).resolve())), ("this", here),
             ("this", here), ("parent", str(Path(parent).resolve()))]
    print(card(), flush=True)
    runs = []
    for tag, root in trees:
        env = {**os.environ, "PYTHONPATH": root}
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--measure"], cwd=root, env=env,
                           capture_output=True, text=True)
        vals = {}
        for line in p.stdout.splitlines():
            if not line.startswith("{"):
                continue
            obj = json.loads(line)
            if "ab" in obj:
                vals.update(obj["ab"])
            for k in FRAME_KEYS.get(obj.get("phase"), ()):
                vals[f"{obj['phase']}.{k}"] = obj.get(k)
        if p.returncode:
            print(f"{tag} failed ({p.returncode}):\n{p.stderr[-4000:]}",
                  flush=True)
            return 1
        runs.append(vals)
        print(tag, json.dumps(vals), flush=True)
    for k in runs[0]:
        print(k, " ".join(f"{r.get(k)}" for r in runs), flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("dense_tail_variants: no CUDA device", file=sys.stderr)
        sys.exit(1)
    args = sys.argv[1:]
    if args[:1] == ["--measure"]:
        sys.exit(measure())
    if args[:1] == ["--ab"]:
        sys.exit(ab(args[1]))
    sys.exit(variants(args))
