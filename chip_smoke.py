#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

The path is ESRGAN RRDBNet x4 (features 64, 23 RRDBs, growth 32,
pixelshuffle) over a 1080x1920 image in 360x240 tiles with halo 8, in
bf16, with random weights from a seed: the fused trunk (kernel B1, 69
dense blocks) over all 24 tiles at once, then the x4 tail (kernels B2 and
B3) in chunks of TAIL_BATCH tiles. The kernels are built from
superresolution_tpu_torch/ops/csrc/ at the start.

Phases, each printing one JSON line; any failure raises, so the exit code
is not 0:
  1 env      torch / CUDA versions, the card's name and power limit
  2 build    nvcc build of the kernels, seconds
  3 kernel   each kernel against its plain PyTorch version on the card,
             at the CHIPEQ geometry, a ragged one and the main path's:
             max |kernel - plain| / max |plain| <= 0.02; timed there.
             B1 is held on its output, its conv part and each of its
             four intermediates, and its check must fail on each of
             B1_FAULTS planted in turn
  4 path     the 2K frame through the kernels, launches counted; shape and
             finiteness; trunk features and the unclipped frame against
             the same path through the plain model within 0.03
  5 times    frame MP/s, trunk and tail ms
Then the kernels line, the card's nvidia-smi line and, last,
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py   (one CUDA GPU; nvcc in $CUDA_HOME/bin,
/usr/local/cuda/bin or on PATH)
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

SEED = 0
H, W = 1080, 1920
TILE, HALO = (360, 240), 8
TAIL_BATCH = 8            # 3 tail chunks over the 24 tiles
TOL_KERNEL = 0.02         # CHIPEQ's bar for fused_dense_block / phase_tail
TOL_PATH = 0.03           # 69 chained bf16 blocks round more than one call
PEAK_FLOPS = 989e12       # H100 SXM dense bf16
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SRC = "superresolution_tpu_torch/ops/csrc/sr_kernels.cu"
# multiply-accumulates per pixel of each op (c=64, g=32)
B1_MACS = 9 * sum((64 + j * 32) * (32 if j < 4 else 64) for j in range(5))
B2_MACS = 4 * 9 * 64 * 256 + 16 * 9 * 64 * 64     # per LR pixel
B3_MACS = 9 * 64 * 3                              # per HR pixel


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor,
            tol: float, **extra) -> dict:
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite values")
    d = float((g - r).abs().max())
    rel = d / max(float(r.abs().max()), 1e-6)
    res = {"check": name, "max_abs_err": d, "max_rel_err": rel, "tol": tol,
           **extra}
    emit(res)
    if rel > tol:
        raise AssertionError(f"{name}: relative error {rel} > {tol}")
    return res


def time_ms(fn, iters: int) -> float:
    """Mean device ms of fn over `iters` launches, after one warm-up."""
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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def dense_check_weights(gen: torch.Generator, c: int = 64, g: int = 32):
    """B1's weights for its check: MSRA x 2 kernels and N(0, 0.1) biases.
    At the model's MSRA x 0.1 the convs make up ~2% of B1's output and the
    identity term x the rest, so a check of the output could not see
    them; at x 2 they make up most of it (conv_share in the check line)."""
    from superresolution_tpu_torch.ops import dense_trunk as dt

    ks, bs = [], []
    for j in range(5):
        cin, cout = c + j * g, g if j < 4 else c
        ks.append(torch.randn(3, 3, cin, cout, generator=gen)
                  * 2 * (2 / (9 * cin)) ** 0.5)
        bs.append(torch.randn(cout, generator=gen) * 0.1)
    return dt.dense_weights(ks, bs, device="cuda")


def check_dense_block(ws, x: torch.Tensor, res: torch.Tensor,
                      tag: str) -> dict:
    """B1 against its plain version in f32 on the same (upcast) inputs,
    without and with `res`. Three kinds of check, each within TOL_KERNEL
    of the plain one's max:
      - the output;
      - its conv part: (out - x) / 0.2, or (out - res - 0.2 x) / 0.04;
      - each of y_1..y_4 in the workspace; the kernel's starts as NaN, so
        a slice that no launch writes fails.
    The plain version runs in f32 because the conv part's 1/0.04 would
    magnify its own bf16 roundings to about half the bar. Returns the
    worse of the two output checks."""
    from superresolution_tpu_torch.ops import dense_trunk as dt

    b, h, w, _ = x.shape
    g = ws[0][0].shape[-1]
    worst = []
    for suffix, r in (("", None), ("+residual", res)):
        name = f"fused_dense_block/{tag}{suffix}"
        wk = torch.full((b, h, w, 4 * g), float("nan"), dtype=x.dtype,
                        device=x.device)
        wp = torch.empty(wk.shape, dtype=torch.float32, device=x.device)
        before = dt.fused_dense_block.launches
        got = dt.fused_dense_block(x, ws, r, workspace=wk)
        if dt.fused_dense_block.launches != before + 5:
            raise AssertionError(f"{name}: launch count did not go up by 5")
        ref = dt.fused_dense_block_reference(
            x.float(), ws, None if r is None else r.float(), workspace=wp)
        worst.append(compare(name, got, ref, TOL_KERNEL))
        ident, k = ((x.float(), 0.2) if r is None
                    else (r.float() + 0.2 * x.float(), 0.04))
        conv_ref = ref - ident
        compare(f"{name}/conv_part", (got.float() - ident) / k, conv_ref / k,
                TOL_KERNEL, conv_share=float(conv_ref.abs().max()
                                             / ref.abs().max()))
        for j in range(4):
            sl = slice(j * g, (j + 1) * g)
            compare(f"{name}/y{j + 1}", wk[..., sl], wp[..., sl], TOL_KERNEL)
    return max(worst, key=lambda e: e["max_rel_err"])


# Faults planted in one of B1's five launches (0-based) by changing that
# launch's arguments. check_dense_block must fail on every one of them.
B1_FAULTS = {
    "conv1_no_lrelu": (0, lambda a: a.update(lrelu=False)),
    "conv2_wrong_out_off": (1, lambda a: a.update(out_off=2 * a["cout"])),
    "conv3_no_bias": (2, lambda a: a.update(bias=None)),
    "conv5_no_bias": (4, lambda a: a.update(bias=None)),
    "conv5_skips_y4": (4, lambda a: a.update(
        cin1=a["cin1"] - 32, w=a["w"][:, :, :-32].contiguous())),
    "conv5_zero": (4, lambda a: a.update(w=torch.zeros_like(a["w"]),
                                         bias=None)),
}


def check_dense_block_faults(ws, x: torch.Tensor, res: torch.Tensor) -> None:
    """Run B1's check with each of B1_FAULTS planted; raise if the check
    passes any of them."""
    from superresolution_tpu_torch.ops import _build

    real = _build.conv3x3
    names = ("in0", "cin0", "w", "bias", "out", "out_off", "cout")
    for fault, (launch, change) in B1_FAULTS.items():
        count = [0]

        def planted(*args, **kw):
            a = dict(zip(names, args), **kw)
            if count[0] % 5 == launch:
                change(a)
            count[0] += 1
            real(**a)

        _build.conv3x3 = planted
        try:
            check_dense_block(ws, x, res, f"fault:{fault}")
        except AssertionError as e:
            emit({"planted_fault": fault, "caught": True, "by": str(e)})
            continue
        finally:
            _build.conv3x3 = real
        raise AssertionError(f"B1's check passed with {fault} planted")


def check_kernels(model, gen: torch.Generator, n_tiles: int) -> dict:
    """Phase 3: B1, B2, B3 against their plain versions, at the CHIPEQ
    geometry, at a ragged one and at the main path's shapes; timed at the
    latter."""
    from superresolution_tpu_torch.infer.common import hwio
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import phase_tail as pt

    dev, bf = torch.device("cuda"), torch.bfloat16
    sd = model.state_dict()
    ws = dense_check_weights(gen)
    tail_w = [hwio(sd["conv_up2.weight"]).to(bf), sd["conv_up2.bias"].float(),
              hwio(sd["conv_hr.weight"]).to(bf), sd["conv_hr.bias"].float()]
    last_w = [hwio(sd["conv_last.weight"]).to(bf),
              sd["conv_last.bias"].float()]

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, bf)

    th, tw = TILE[0] + 2 * HALO, TILE[1] + 2 * HALO
    out = {}
    # "ragged" leaves partial thread-block tiles at every image edge
    for geom, (b, h, w) in (("chipeq", (2, 48, 64)), ("ragged", (1, 37, 45)),
                            ("main", (n_tiles, th, tw))):
        # res small, so the convs make up most of B1's residual output too
        x, res = randn(b, h, w, 64, scale=0.2), randn(b, h, w, 64, scale=0.05)
        e1 = check_dense_block(ws, x, res, geom)
        if geom == "chipeq":
            check_dense_block_faults(ws, x, res)
        bt = min(b, TAIL_BATCH)
        z1 = F.leaky_relu(randn(bt, h, w, 256, scale=0.3), 0.2)
        before = pt.up2_hr.launches
        y_ref = pt.up2_hr_reference(z1, *tail_w)
        e2 = compare(f"up2_hr/{geom}", pt.up2_hr(z1, *tail_w), y_ref,
                     TOL_KERNEL)
        if pt.up2_hr.launches <= before:
            raise AssertionError("up2_hr did not count launches")
        before = pt.conv_last_phase.launches
        e3 = compare(f"conv_last_phase/{geom}",
                     pt.conv_last_phase(y_ref, *last_w),
                     pt.conv_last_phase_reference(y_ref, *last_w),
                     TOL_KERNEL)
        if pt.conv_last_phase.launches <= before:
            raise AssertionError("conv_last_phase did not count launches")
        if geom != "main":
            continue

        px = b * h * w
        lr_px, hr_px = bt * h * w, bt * h * w * 16
        lw_oihw = last_w[0].permute(3, 2, 0, 1).contiguous()
        y_nchw = y_ref.permute(0, 3, 1, 2)
        rows = [
            ("fused_dense_block", "superresolution_tpu/ops/"
             "pallas_dense_trunk.py:237",
             e1, lambda: dt.fused_dense_block(x, ws, res),
             lambda: dt.fused_dense_block_reference(x, ws, res), None, 5,
             2 * px * B1_MACS, 3 * px * 64 * 2 + 2 * B1_MACS + 4 * 192,
             [b, h, w, 64]),
            ("up2_hr", "superresolution_tpu/ops/pallas_phase_tail.py:319", e2,
             lambda: pt.up2_hr(z1, *tail_w),
             lambda: pt.up2_hr_reference(z1, *tail_w), None, 3,
             2 * lr_px * B2_MACS,
             lr_px * 256 * 2 + hr_px * 64 * 2 + 2 * 9 * 64 * 320 + 4 * 320,
             [bt, h, w, 256]),
            ("conv_last_phase", "superresolution_tpu/ops/"
             "pallas_phase_tail.py:340", e3,
             lambda: pt.conv_last_phase(y_ref, *last_w),
             lambda: pt.conv_last_phase_reference(y_ref, *last_w),
             lambda: F.conv2d(y_nchw, lw_oihw, last_w[1].to(bf), padding=1),
             10, 2 * hr_px * B3_MACS, hr_px * (64 + 3) * 2 + 2 * 9 * 64 * 3,
             [bt, 4 * h, 4 * w, 64]),
        ]
        for name, tpu, err, kern, plain, lib, iters, flops, nbytes, shape \
                in rows:
            b_ms, b_by = bound(flops, nbytes)
            out[name] = {
                "name": name, "route": "cuda", "source": SRC,
                "replaces": tpu, "shape": shape,
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"], "tol": TOL_KERNEL,
                "ms": time_ms(kern, iters), "plain_ms": time_ms(plain, iters),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if lib is None else time_ms(lib, iters)}
            emit({"phase": "kernel_time", **out[name]})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from superresolution_tpu_torch.infer.fused_trunk import make_fused_trunk
    from superresolution_tpu_torch.infer.phase_tail import make_phase_tail
    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer_staged)
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops.dense_trunk import fused_dense_block
    from superresolution_tpu_torch.ops.phase_tail import (
        conv_last_phase, up2_hr)
    from superresolution_tpu_torch.runtime import exact_fp32_reference

    t_start = time.perf_counter()
    exact_fp32_reference()
    card = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card})

    _, build_s, ptxas = _build.build()
    _build.library()
    print("\n".join(line for line in ptxas.splitlines()
                    if "registers" in line or "spill" in line),
          file=sys.stderr)
    emit({"phase": "build", "seconds": build_s})

    gen = torch.Generator().manual_seed(SEED)
    model = RRDBNet(scale=4, in_channels=3, out_channels=3, features=64,
                    num_blocks=23, growth=32, upsampler="pixelshuffle",
                    generator=gen).to(torch.bfloat16).eval()
    with torch.no_grad():  # nonzero biases, so every check covers them
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    params = model.state_dict()
    ny, nx = -(-H // TILE[0]), -(-W // TILE[1])
    kernels = check_kernels(model, gen, ny * nx)
    torch.cuda.empty_cache()

    # ---- 4: the main path ----
    img = torch.rand((H, W, 3), generator=gen).cuda()
    fused = make_fused_trunk(params, model)

    def trunk_fn(x):
        return fused(x.to(torch.bfloat16))

    geom = dict(scale=4, tile=TILE, halo=HALO, tail_batch=TAIL_BATCH, h=H,
                w=W, channels=3)
    runner = make_tiled_infer_staged(trunk_fn, make_phase_tail(params),
                                     **geom)
    ops = {"fused_dense_block": fused_dense_block, "up2_hr": up2_hr,
           "conv_last_phase": conv_last_phase}
    for op in ops.values():
        op.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = runner(img)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: op.launches for k, op in ops.items()}
    chunks = -(-ny * nx // TAIL_BATCH)
    expected = {"fused_dense_block": 69 * 5, "up2_hr": 2 * chunks,
                "conv_last_phase": chunks}
    if launches != expected:
        raise AssertionError(f"launches {launches} != expected {expected}")
    if tuple(out.shape) != (4 * H, 4 * W, 3):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")
    emit({"phase": "path", "output_shape": list(out.shape),
          "dtype": str(out.dtype), "first_run_s": first_s,
          "launches_per_frame": launches, "tail_batch": TAIL_BATCH,
          "tail_chunks": chunks,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    for k in kernels:
        kernels[k]["launches"] = launches[k]

    run_trunk, run_tail = make_tiled_infer_staged(
        trunk_fn, make_phase_tail(params, clip=False), split_stages=True,
        **geom)
    plain_trunk, plain_tail = make_tiled_infer_staged(
        lambda x: model.trunk(x.to(torch.bfloat16)), model.tail,
        split_stages=True, **geom)
    with torch.inference_mode():
        feats = run_trunk(img)
        ref_feats = plain_trunk(img)
        compare("path/trunk_features", feats, ref_feats, TOL_PATH)
        compare("path/frame_unclipped", run_tail(feats),
                plain_tail(ref_feats), TOL_PATH)
        del ref_feats
        torch.cuda.empty_cache()

        # ---- 5: times on the card ----
        def host_s(fn, runs=2):
            t = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            return sum(t) / len(t)

        frame_s = host_s(lambda: runner(img))
        trunk_s = host_s(lambda: run_trunk(img))
        tail_s = host_s(lambda: run_tail(feats))
    px_tiles = ny * nx * (TILE[0] + 2 * HALO) * (TILE[1] + 2 * HALO)
    frame_macs = px_tiles * (9 * 3 * 64 + 69 * B1_MACS + 9 * 64 * 64
                             + 9 * 64 * 256 + B2_MACS + 16 * B3_MACS)
    emit({"phase": "times", "card": card, "frame_s": frame_s,
          "mp_per_s": H * W / 1e6 / frame_s, "trunk_ms": trunk_s * 1e3,
          "tail_ms": tail_s * 1e3,
          "frame_bound_ms": 2 * frame_macs / PEAK_FLOPS * 1e3,
          "frame_tflop_per_s": 2 * frame_macs / frame_s / 1e12,
          "total_s": time.perf_counter() - t_start})

    emit({"kernels": list(kernels.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
