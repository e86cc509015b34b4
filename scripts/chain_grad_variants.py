"""Time variants of kernel 6 (the persistent tensor-core RRDB) and of
kernel 13's weight grad, and compare two trees, on one GPU.

Variants. Each is the port's sources under a few text edits, built by
nvcc into its own library beside the port's own build and called through
the same C entry points (dense_rrdb; train_wgrad_tc). Each is checked
against the main build's result (max |err| / max |main| printed) and
timed with CUDA events at the main path's shapes: kernel 6 at
[24,376,256,64]; the weight grads of one dense block's five convs at
hybrid_astro's [4,128,128,64] (C 64, g 32), each alone and the five
together; and kernel 13's whole call there.
  k6_overlap    the next tile's halo staged during this tile's epilogue
                (the output tile over the weight ring) in place of one
                tile at a time through the engine's tile body
  k6_conv5_8_rows  conv 5's stage in 8-row tiles, as B1's, in place of
                4 (its ~100 KB then hold every stage to two blocks an SM)
  k6_one_block, k6_two_blocks  kernel 6's grid capped at one or two
                blocks an SM (three fit)
  wg_ci16, wg_ci64   16 or 64 input channels a block (dW rows 9 x CI) in
                place of 32: three or twelve warps
  wg_co32       every conv's columns in 32-column blocks (conv 5's 64
                columns in two blocks) in place of one 64-column block
  wg_chunks1, wg_chunks4   one or four blocks an SM in the pixel-chunk
                count, in place of two (fewer or more f32 partials)

A/B (--ab PARENT): runs the measurements below in the parent tree (a
checkout of the commit before, e.g. unpacked by `git archive` under
outputs/) and in this one, each in its own process, in the order parent,
this, this, parent, and prints one line a metric with the four values:
kernel 6 and kernel 13 at their main shapes, B1 and B2 at theirs,
kernels 15 and 18 at theirs; the ESRGAN 2K frame (default and under
chain_rrdb, host clock); and from each tree's chip_smoke.py the hybrid
and h200-class frames and a hybrid_astro training step's device ms.

Usage (one GPU, nvcc as for the port's build), from the repo's root:
  python -m scripts.chain_grad_variants [variant ...]
  python -m scripts.chain_grad_variants --ab outputs/parent
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

K6 = "dense_kernels.cu"
WG = "train_tc_kernels.cu"
STAGE = """  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    tc::tile_body<DenseConv<bf16>, BN, ROWS>(a, t, smem);
    __syncthreads();  // every bulk copy has read the tile: restage
  }
"""
OVERLAP = """  int t = blockIdx.x;
  if (t >= tiles) return;
  using P = DenseConv<bf16>;
  const int pstr = ((a.cin() + 15) & ~15) + 8;
  bf16* ring = tc::halo_tile(smem) + (ROWS + 2) * tc::IW * pstr;
  tc::zero_row(smem);
  tc::Tile tl = tc::tile_at<BN, ROWS>(a, t);
  tc::stage_input<ROWS>(a, tl, smem);
  conv_engine::cp_async_commit();
  for (; t < tiles; t += gridDim.x) {
    float acc[tc::Shape<BN, ROWS>::MF][tc::Shape<BN, ROWS>::NF][4];
    tc::tile_gemm<P, BN, ROWS>(a, tl, true, smem, acc);
    const tc::Tile cur = tl;
    if (t + (int)gridDim.x < tiles) {  // the halo tile is free: stage
      tl = tc::tile_at<BN, ROWS>(a, t + gridDim.x);
      tc::stage_input<ROWS>(a, tl, smem);
    }
    conv_engine::cp_async_commit();
    tc::tile_epilogue<P, BN, ROWS>(a, cur, ring, acc);
    __syncthreads();  // every bulk copy has read the ring: reload it
  }
"""
FIT = "  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;\n"
VARIANTS = {
    "k6_overlap": [(K6, STAGE, OVERLAP)],
    "k6_one_block": [(K6, FIT, FIT + "  fit = 1;\n")],
    "k6_two_blocks": [(K6, FIT, FIT + "  fit = fit < 2 ? fit : 2;\n")],
    "k6_conv5_8_rows": [(K6, "constexpr int RRDB_TH_C = 4;",
                         "constexpr int RRDB_TH_C = 8;")],
    "wg_ci16": [(WG, "constexpr int CI = 32; ", "constexpr int CI = 16; ")],
    "wg_ci64": [(WG, "constexpr int CI = 32; ", "constexpr int CI = 64; ")],
    "wg_co32": [(WG, "cout <= 32 ? 1 : (cout + 63) / 64",
                 "(cout + 31) / 32"),
                (WG, "  if (cout <= 32) {\n    e = conv_engine",
                 "  if (true) {\n    e = conv_engine"),
                (WG, "const int co = cout <= 32 ? 32 : 64;",
                 "const int co = 32;")],
    "wg_chunks1": [(WG, "constexpr int BLOCKS_PER_SM = 2;",
                    "constexpr int BLOCKS_PER_SM = 1;")],
    "wg_chunks4": [(WG, "constexpr int BLOCKS_PER_SM = 2;",
                    "constexpr int BLOCKS_PER_SM = 4;")],
}
# the sources a variant's library is built from, by the file it edits
BUILDS = {K6: ("conv_engine.cuh", "dense_kernels.cu", "sr_kernels.cu"),
          WG: ("conv_engine.cuh", "train_tc_kernels.cu", "train_kernels.cu",
               "sr_kernels.cu")}
ENTRIES = ("dense_rrdb", "train_wgrad_tc", "train_wgrad_tc_chunks",
           "sr_error_string")


def build(name: str, edits, workdir: Path):
    """The variant's library and its ptxas report's register lines."""
    from superresolution_tpu_torch.ops import _build

    d = workdir / name
    d.mkdir()
    files = BUILDS[edits[0][0]]
    for f in files:
        s = (_build.SRC_DIR / f).read_text()
        for target, old, new in edits:
            if target == f:
                if old not in s:
                    raise ValueError(f"{name}: {old!r} not in {f}")
                s = s.replace(old, new)
        (d / f).write_text(s)
    cus = [f for f in files if f.endswith(".cu")]
    objs = [str(d / f"{f}.o") for f in cus]

    def nvcc(f, o):
        return subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                               str(d / f), "-o", o], capture_output=True,
                              text=True)

    with ThreadPoolExecutor(len(objs)) as ex:
        procs = list(ex.map(nvcc, cus, objs))
    for p in procs:
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{p.stderr}")
    so = str(d / "lib.so")
    subprocess.run([_build._nvcc(), "-shared", "-o", so, *objs], check=True)
    lib = ctypes.CDLL(so)
    main = _build.library()
    for fn in ENTRIES:
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = getattr(main, fn).argtypes
            getattr(lib, fn).restype = getattr(main, fn).restype
    return Variant(lib, main), usage("".join(p.stderr for p in procs))


class Variant:
    """A variant's library for _build's helpers: its own ENTRIES, the
    main build's every other entry (B1's convs for kernel 13's
    recompute, ...)."""

    def __init__(self, lib, main):
        self.lib, self.main = lib, main

    def __getattr__(self, name):
        if name in ENTRIES and hasattr(self.lib, name):
            return getattr(self.lib, name)
        return getattr(self.main, name)


def usage(report: str) -> str:
    """The new kernels' registers and spills, one item each."""
    import chip_smoke as cs

    return " ".join(f"{k}:{v['registers']}r/{v['spill_bytes']}s"
                    for k, v in cs.chain_grad_ptxas(report).items())


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
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def with_library(lib, fn):
    from superresolution_tpu_torch.ops import _build

    real = _build.library
    _build.library = lambda: lib
    try:
        return fn()
    finally:
        _build.library = real


def cases(gen: torch.Generator):
    """(tag, the file its variants edit, launch() -> output, iters) at the
    main shapes."""
    import chip_smoke as cs
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt

    bf = torch.bfloat16
    b, h, w, c, g = 24, 376, 256, 64, 32
    ws3 = [cs.dense_check_weights(gen) for _ in range(3)]
    flat = [p for ws in ws3 for p in ws]
    x = cs.rand(gen, b, h, w, c, scale=0.2, dtype=bf)
    scratch = (torch.empty(b, h, w, 4 * g, dtype=bf, device="cuda"),
               torch.empty_like(x))
    out = torch.empty_like(x)

    def k6():
        _build.rrdb_tc(x, flat, *scratch, out)
        return out

    yield "k6", K6, k6, 3
    del x, scratch, out
    torch.cuda.empty_cache()
    b, h, w = 4, 128, 128
    ws = cs.dense_check_weights(gen)
    x = cs.rand(gen, b, h, w, c, scale=0.2, dtype=bf)
    dout = cs.rand(gen, b, h, w, c, dtype=bf)
    y = torch.empty(b, h, w, 4 * g, dtype=bf, device="cuda")
    dt.dense_features(x, ws, y)
    d = cs.rand(gen, b, h, w, 4 * g + c, scale=0.05, dtype=bf)
    grads = [(torch.empty_like(k), torch.empty_like(bb)) for k, bb in ws]

    def wgrad(j):
        k = ws[j - 1][0]
        d_off = 0 if j == 5 else c + (4 - j) * g
        _build.wgrad_tc(x, c, y if j > 1 else None, (j - 1) * g, d, d_off,
                        k.shape[-1], *grads[j - 1])
        return grads[j - 1][0]

    for j in range(1, 6):
        yield f"wgrad{j}", WG, lambda j=j: wgrad(j), 20

    def all_wgrads():
        for j in range(1, 6):
            wgrad(j)
        return torch.cat([t.reshape(-1).float() for pair in grads
                          for t in pair])

    yield "wgrad_all", WG, all_wgrads, 20
    yield "k13", WG, lambda: dtt.dense_block_backward(
        x, ws, None, dout)[0], 20


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
        with ThreadPoolExecutor(3) as ex:  # up to three nvcc processes each
            built = list(ex.map(lambda n: build(n, VARIANTS[n], Path(tmp)),
                                names))
        for name, (lib, use) in zip(names, built):
            libs[name] = lib
            print(name, use, flush=True)
        gen = torch.Generator().manual_seed(0)
        with torch.inference_mode():
            for tag, edits, launch, iters in cases(gen):
                ref = launch().clone()
                line = [tag, f"main {time_ms(launch, iters):.4f} ms"]
                for name in names:
                    if VARIANTS[name][0][0] != edits:
                        continue
                    got = with_library(libs[name], launch).clone()
                    ms = with_library(libs[name],
                                      lambda: time_ms(launch, iters))
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
    JSON line of measurements, and chip_smoke.py's frame and step
    lines."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from superresolution_tpu_torch.infer.fused_trunk import make_fused_trunk
    from superresolution_tpu_torch.infer.phase_tail import make_phase_tail
    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer_staged)
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt
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
        ws3 = [cs.dense_check_weights(gen) for _ in range(3)]
        x = (torch.randn(24, 376, 256, 64, generator=gen) * 0.2).to(dev, bf)
        r = (torch.randn(24, 376, 256, 64, generator=gen) * 0.05).to(dev, bf)
        res["k6_ms"] = time_ms(lambda: dt.fused_rrdb(x, *ws3), 3)
        res["b1_ms"] = time_ms(lambda: dt.fused_dense_block(x, ws3[0], r),
                               10)
        del x, r
        torch.cuda.empty_cache()
        z1 = F.leaky_relu(torch.randn(8, 376, 256, 256, generator=gen)
                          * 0.3, 0.2).to(dev, bf)
        tw = [(torch.randn(3, 3, 64, 256, generator=gen) * 0.06).to(dev, bf),
              (torch.randn(256, generator=gen) * 0.02).to(dev),
              (torch.randn(3, 3, 64, 64, generator=gen) * 0.06).to(dev, bf),
              (torch.randn(64, generator=gen) * 0.02).to(dev)]
        z1p, up2p = pt.to_phase_major(z1), pt.phase_major_up2(*tw[:2])
        res["b2_ms"] = time_ms(lambda: pt.up2_hr(
            z1p, *tw, layout="phase", up2_phase=up2p), 5)
        del z1, z1p
        torch.cuda.empty_cache()
        for tag, bsz, hw, cin, cout, r_ in (("k15_edsr1", 8, 288, 64, 64, 2),
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
        xs = torch.randn((24, 376, 256, 64), generator=gen).to(dev)
        xp = pc.pack_input(xs, 2).to(bf)
        wk = pc.kmajor_weights((torch.randn((3, 3, 64, 192), generator=gen)
                                / 24).to(dev), bf)
        bias = torch.zeros(192, device=dev)
        o = torch.empty((*xp.shape[:3], 2 * 192), dtype=bf, device=dev)
        res["k18_c64_n192_ms"] = time_ms(lambda: _build.pack_conv(
            xp, wk, bias, o, 2, 256, False, True), 10)
        del xs, xp, o
        torch.cuda.empty_cache()
    ws = cs.dense_check_weights(gen)
    x = (torch.randn(4, 128, 128, 64, generator=gen) * 0.2).to(dev, bf)
    dout = torch.randn(4, 128, 128, 64, generator=gen).to(dev, bf)
    res["k13_ms"] = time_ms(lambda: dtt.dense_block_backward(
        x, ws, None, dout), 10)
    del x, dout
    with torch.inference_mode():
        gen = torch.Generator().manual_seed(cs.SEED)
        model = RRDBNet(scale=4, in_channels=3, out_channels=3, features=64,
                        num_blocks=23, growth=32, upsampler="pixelshuffle",
                        generator=gen).to(bf).eval()
        params = model.state_dict()
        img = torch.rand((cs.H, cs.W, 3), generator=gen).cuda()
        geom = dict(scale=4, tile=cs.TILE, halo=cs.HALO,
                    tail_batch=cs.TAIL_BATCH, h=cs.H, w=cs.W, channels=3)
        for lever in (None, "chain_rrdb"):
            fused = make_fused_trunk(params, model,
                                     **({lever: True} if lever else {}))
            runner = make_tiled_infer_staged(
                lambda t, f=fused: f(t.to(bf)), make_phase_tail(params),
                **geom)
            runner(img)
            res[f"esrgan_{lever or 'default'}_frame_s"] = cs.host_clock(
                lambda: runner(img))
            del runner, fused
            torch.cuda.empty_cache()
        del model, params, img
        torch.cuda.empty_cache()
    crd = cs.nvidia_smi()
    print(json.dumps({"ab": res, "card": crd}), flush=True)
    cs.zero_counts()
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    cs.hybrid_path(gen, crd)
    torch.cuda.empty_cache()
    cs.h200_path(torch.Generator().manual_seed(cs.SEED + 4), crd)
    torch.cuda.empty_cache()
    cs.train_path(crd)
    return 0


FRAME_KEYS = {"hybrid_times": ("frame_ms", "device_ms_per_frame"),
              "h200_times": ("fused_ms",),
              "train_times": ("ms_per_step", "device_ms_per_step")}


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
        print("chain_grad_variants: no CUDA device", file=sys.stderr)
        sys.exit(1)
    args = sys.argv[1:]
    if args[:1] == ["--measure"]:
        sys.exit(measure())
    if args[:1] == ["--ab"]:
        sys.exit(ab(args[1]))
    sys.exit(variants(args))
