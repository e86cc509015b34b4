"""Build and bind the port's CUDA kernels (ops/csrc/*.cu).

nvcc compiles every source into one shared library with a plain C
interface (sm_90a), at first use, into superresolution_tpu_torch/_build/
under a name keyed by a hash of the sources and flags; ctypes loads it.
Each .cu is compiled by its own nvcc process, all started together, and
one more links the objects.
Nothing is downloaded, and a build or launch failure raises: no caller
falls back to a plain version on the card.

The launch helpers take CUDA tensors, pass raw pointers and PyTorch's
current stream, and raise if the launch returns a CUDA error. Callers
validate shapes first (require_cuda checks device, dtype, contiguity and
alignment).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.c_size_t
_L = ctypes.c_longlong


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def build() -> tuple[Path, float, str]:
    """Compile the sources if no library with their hash exists.
    Returns (library path, build seconds (0 when cached), ptxas report,
    which ends with a line "nvcc seconds: <source> <s>, ..." of each
    source's compile time)."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"libsr_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in (p for p in srcs if p.suffix == ".cu"):
            objs.append(str(Path(tmpdir) / f"{src.stem}.o"))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", objs[-1]],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

        def finish(p):  # its output, and the seconds until it ended
            out = p.communicate()
            return out, time.perf_counter() - t0

        with ThreadPoolExecutor(len(procs)) as pool:
            ends = list(pool.map(finish, procs))
        outs = [out for out, _ in ends]
        report = []
        for proc, (out, err) in zip(procs, outs):
            report.append(err)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{out}\n{err}")
        report.append("nvcc seconds: " + ", ".join(
            f"{Path(o).stem}.cu {t:.1f}" for o, (_, t) in zip(objs, ends))
            + "\n")
        tmp = str(Path(tmpdir) / lib.name)
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib, seconds, "".join(report)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.sr_conv3x3.argtypes = [_P, _I, _I, _P, _I, _I, _I, _I, _I,
                               _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I,
                               _F, _P, _I, _P, _I, _I, _I, _I, _P]
    lib.sr_conv3x3.restype = _I
    lib.dense_conv.argtypes = [_P, _P, *[_I] * 6, _P, _P, _P, *[_I] * 4,
                               _P, _P, _P, _I, _I, _I, _I, _P]
    lib.dense_conv.restype = _I
    lib.dense_first_conv.argtypes = [_P, *[_I] * 4, _P, _P, _P, _I, _I, _P]
    lib.dense_first_conv.restype = _I
    lib.dense_rrdb.argtypes = [_P, _P, _P, _P, _P, _P, *[_I] * 6, _P]
    lib.dense_rrdb.restype = _I
    lib.tail_up_conv.argtypes = [_P, *[_I] * 4, _P, _P, _P, _I, _I, _I, _P]
    lib.tail_up_conv.restype = _I
    lib.stream_conv_last.argtypes = [_P, _I, _I, _I, _I, _P, _P, _I, _P,
                                     _I, _P]
    lib.stream_conv_last.restype = _I
    lib.sr_dense_prologue.argtypes = [_P, _I, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _P]
    lib.sr_dense_prologue.restype = _I
    lib.sr_dense_epilogue.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _I, _P]
    lib.sr_dense_epilogue.restype = _I
    lib.sr_rrdb.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P]
    lib.sr_rrdb.restype = _I
    lib.hat_layernorm.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P]
    lib.hat_layernorm.restype = _I
    lib.hat_hab_block.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                  _I, _F, _I, _I, _P]
    lib.hat_hab_block.restype = _I
    lib.hat_strip_hab.argtypes = [_P, _P, _P, _P, *[_I] * 8, _P, _F, _I, _P]
    lib.hat_strip_hab.restype = _I
    lib.cab_tc.argtypes = [_P, *[_I] * 6, *[_P] * 8, _I, _P]
    lib.cab_tc.restype = _I
    lib.cab_tc_smem.argtypes = [_I, _I]
    lib.cab_tc_smem.restype = _S
    lib.hat_oca.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F, _I, _P]
    lib.hat_oca.restype = _I
    lib.train_star_l1_parts.argtypes = [_S]
    lib.train_star_l1_parts.restype = _I
    lib.train_star_l1_value.argtypes = [_P, _P, _S, _F, _F, _P, _P, _P]
    lib.train_star_l1_value.restype = _I
    lib.train_star_l1_grad.argtypes = [_P, _P, _S, _F, _F, _P, _P, _P]
    lib.train_star_l1_grad.restype = _I
    lib.train_dense_scale.argtypes = [_P, _S, _I, _F, _P, _I, _I, _P]
    lib.train_dense_scale.restype = _I
    lib.train_wgrad_chunks.argtypes = [_I] * 5
    lib.train_wgrad_chunks.restype = _I
    lib.train_wgrad.argtypes = [_P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _P, _P, _P, _I, _P]
    lib.train_wgrad.restype = _I
    lib.train_grad_conv.argtypes = [_P, *[_I] * 5, _P, _P, _I, _I, _I, _P,
                                    _I, _P, _I, _F, _I, _I, _I, _I, _P]
    lib.train_grad_conv.restype = _I
    lib.train_wgrad_tc_chunks.argtypes = [_I] * 5
    lib.train_wgrad_tc_chunks.restype = _I
    lib.train_wgrad_tc.argtypes = [*lib.train_wgrad.argtypes[:-2], _P]
    lib.train_wgrad_tc.restype = _I
    lib.train_flip_weights.argtypes = [_P, _I, _I, _P, _P]
    lib.train_flip_weights.restype = _I
    lib.attn_window.argtypes = [_P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P,
                                _I, _P, _I, _I, _I, _I, _I, _F, _I, _P]
    lib.attn_window.restype = _I
    lib.attn_window_tc.argtypes = [_P, _L, _L, _P, _L, _L, _P, _L, _L, _P,
                                   _P, _I, _P, _I, _I, _I, _I, _I, _F, _P]
    lib.attn_window_tc.restype = _I
    lib.attn_map_tc.argtypes = [_P, _P, _P, *[_I] * 7, _F, _I, _P]
    lib.attn_map_tc.restype = _I
    lib.subpixel_conv3x3_d2s.argtypes = [_P, _L, _L, _L, _L, _I, _I, _I,
                                         _I, _P, _I, _P, _I, _I, _P, _I, _I,
                                         _I, _P]
    lib.subpixel_conv3x3_d2s.restype = _I
    lib.dense_valid_stage.argtypes = [_P, _P, _P, _P, _P, *[_I] * 8, _P]
    lib.dense_valid_stage.restype = _I
    lib.dense_valid_stage_tc.argtypes = [_P, _P, _P, _P, _P, *[_I] * 7, _P]
    lib.dense_valid_stage_tc.restype = _I
    lib.extra_blur.argtypes = [_P, _P, *[_I] * 5, ctypes.c_double, _I, _I,
                               _P]
    lib.extra_blur.restype = _I
    lib.extra_pack_conv.argtypes = [_P, _P, _P, _P, *[_I] * 11, _P]
    lib.extra_pack_conv.restype = _I
    lib.stream_copy.argtypes = [_P, _P, _L, _I, _L, _I, _P]
    lib.stream_copy.restype = _I
    lib.extra_noop.argtypes = [_P]
    lib.extra_noop.restype = _I
    lib.sr_error_string.argtypes = [_I]
    lib.sr_error_string.restype = ctypes.c_char_p
    return lib


def activation_dtype(t: torch.Tensor, name: str) -> torch.dtype:
    """t's dtype when a launch helper with an f32 form takes it (bf16 or
    f32), else a TypeError."""
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: expected bf16 or f32, got {t.dtype}")
    return t.dtype


def require_cuda(*tensors: torch.Tensor | None, dtype=torch.bfloat16,
                 name: str) -> None:
    """Raise unless every given tensor is a contiguous, 16-byte aligned
    CUDA tensor of `dtype`, all on one device."""
    devs = set()
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        devs.add(t.device)
    if len(devs) > 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")


def _check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.sr_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def conv3x3(in0: torch.Tensor, cin0: int, w: torch.Tensor,
            bias: torch.Tensor | None, out: torch.Tensor, out_off: int,
            cout: int, *, geom: tuple[int, int, int],
            in1: torch.Tensor | None = None, cin1: int = 0,
            lrelu: bool = False, gelu: bool = False,
            gate: torch.Tensor | None = None, gate_off: int = 0,
            add: torch.Tensor | None = None, add_scale: float = 1.0,
            xres: torch.Tensor | None = None,
            res: torch.Tensor | None = None,
            seg: tuple[int, int] | None = None, seg_plant: int = 0) -> None:
    """One launch of the direct 3x3 SAME conv (sr_kernels.cu
    conv3x3_kernel, on the CUDA cores).

    geom = (B, H, W) of the conv's input; every tensor is NHWC
    with its last dim as the channel stride. w: [3, 3, cin0+cin1, cout]
    bf16; bias: [cout] f32. The epilogue applies bias, then lrelu(0.2)
    or exact GELU, then the lrelu' gate (v *= 0.2 where gate's channel
    gate_off + o is not > 0), then v += add_scale * add, then the
    residuals. seg = (stride, valid): row y is a spacer unless y % stride
    < valid; spacers read as zero and are written as 0 (seg_plant 1, a
    planted fault: not zeroed at the store)."""
    lib = library()
    b, h, wd = geom
    stride, valid = seg or (0, 0)
    gate_ptr = None if gate is None else (
        gate.data_ptr() + gate_off * gate.element_size())
    rc = lib.sr_conv3x3(
        _ptr(in0), in0.shape[-1], cin0,
        _ptr(in1), 0 if in1 is None else in1.shape[-1], cin1,
        b, h, wd, _ptr(w), _ptr(bias),
        _ptr(out), out.shape[-1], out_off, cout, 1 if lrelu else 2 * gelu,
        gate_ptr, 0 if gate is None else gate.shape[-1],
        _ptr(add), 0 if add is None else add.shape[-1], add_scale,
        _ptr(xres), 0 if xres is None else xres.shape[-1],
        _ptr(res), 0 if res is None else res.shape[-1], stride, valid,
        seg_plant, _stream(out))
    _check(lib, rc, "sr_conv3x3")


def dense_conv(x: torch.Tensor, ws: torch.Tensor | None, cin1: int,
               w: torch.Tensor, bias: torch.Tensor | None, out: torch.Tensor,
               out_off: int, *, lrelu: bool = False,
               xres: torch.Tensor | None = None,
               res: torch.Tensor | None = None,
               add: torch.Tensor | None = None,
               seg: tuple[int, int] | None = None,
               seg_plant: int = 0) -> None:
    """One launch of B1's conv on the conv engine (dense_kernels.cu, the
    DenseConv policy): out[..., out_off:out_off + cout] =
    epilogue(conv3x3_SAME([x, ws[..., :cin1]], w) + bias).

    x [B,H,W,C], ws [B,H,W,4g] (its first cin1 channels are the second
    source; None with cin1 0), out [B,H,W,*], xres / res / add [B,H,W,C],
    all NHWC, and w the HWIO [3, 3, C + cin1, cout], all bf16 (the
    tensor-core body; C, cin1, cout, out_off and out's channels multiples
    of 8) or all f32 (the direct body); bias [cout] f32 or None. The
    epilogue: bias, lrelu(0.2) when asked, then v = xres + 0.2 v, then v =
    res + 0.2 v, then v = v + add (kernel 5's trunk_conv), in f32, one
    rounding. seg and seg_plant as conv3x3's."""
    lib = library()
    b, h, wd, c = x.shape
    stride, valid = seg or (0, 0)
    rc = lib.dense_conv(
        _ptr(x), _ptr(ws), b, h, wd, c, 0 if ws is None else ws.shape[-1],
        cin1, _ptr(w), _ptr(bias), _ptr(out), out.shape[-1], out_off,
        w.shape[-1], int(lrelu), _ptr(xres), _ptr(res), _ptr(add), stride,
        valid, seg_plant, int(x.dtype == torch.float32), _stream(x))
    _check(lib, rc, "dense_conv")


# The fault chip_smoke.py plants in kernel 4's conv_first (`plant`, a bit
# beside PLANT_NO_RESIDUAL, PLANT_SWAP_STAGES and PLANT_NO_BARRIER; 0 in
# use; see dense_kernels.cu): its halo read from the border pixel, not
# zero.
PLANT_HALO_CLAMPED = 8


def first_conv(x_raw: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor | None, out: torch.Tensor,
               plant: int = 0) -> None:
    """One launch of kernel 4's conv_first on the conv engine's direct
    body (dense_kernels.cu dense_first_conv, DenseConv<bf16>): out
    [B,H,W,cout] = conv3x3_SAME(x_raw, w) + bias for x_raw [B,H,W,cin] of
    any cin (its pixels need not be 16-byte runs), w the HWIO [3, 3, cin,
    cout], all bf16; bias [cout] f32 or None."""
    lib = library()
    b, h, wd, cin = x_raw.shape
    rc = lib.dense_first_conv(
        _ptr(x_raw), b, h, wd, cin, _ptr(w), _ptr(bias), _ptr(out),
        w.shape[-1], int(bool(plant & PLANT_HALO_CLAMPED)), _stream(x_raw))
    _check(lib, rc, "dense_first_conv")


# Faults chip_smoke.py plants in B2 (`plant`; 0 in use; see
# tail_kernels.cu): the sub-pixel phases (Y & 1, X & 1) read swapped, the
# border read clamped and not zero, the bias dropped.
PLANT_SWAP_PHASE, PLANT_CLAMP_EDGE, PLANT_BIAS_OFF = 1, 2, 3


def up_conv(z: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
            out: torch.Tensor, tc: bool, plant: int = 0) -> None:
    """One of B2's launches (tail_kernels.cu, the PhaseUp policy): out
    [B,2h,2w,n] = lrelu(conv3x3_SAME(d2s(z, 2), w) + bias) for z [B,h,w,4c]
    phase-major (channel p*c + f is sub-pixel p's channel f), w the HWIO
    [3,3,c,n] bf16, bias [n] f32 or None, out bf16. tc: the tensor-core
    body (c % 8 == 0, n % 8 == 0), else the direct body."""
    lib = library()
    b, h, wd, c4 = z.shape
    rc = lib.tail_up_conv(_ptr(z), b, h, wd, c4 // 4, _ptr(w), _ptr(bias),
                          _ptr(out), w.shape[-1], int(tc), plant,
                          _stream(z))
    _check(lib, rc, "tail_up_conv")


# Faults chip_smoke.py plants in B3 (`plant`, a bit mask; 0 in use; see
# stream_kernels.cu): the halo row outside the image clamped to the border
# row, tap (ky 1, kx 0) taken from the wrong neighbour, the bias dropped.
PLANT_ROW_CLAMP, PLANT_WRONG_NEIGHBOUR, PLANT_BIAS_DROPPED = 1, 2, 4


def conv_last(y: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              out: torch.Tensor, plant: int = 0) -> None:
    """One launch of B3, conv_last_kernel (stream_kernels.cu): y
    [B,H,W,cin] -> out [B,H,W,cout] = conv3x3_SAME(y, w) + bias."""
    lib = library()
    b, h, wd, cin = y.shape
    rc = lib.stream_conv_last(_ptr(y), b, h, wd, cin, _ptr(w), _ptr(bias),
                              out.shape[-1], _ptr(out), plant, _stream(y))
    _check(lib, rc, "stream_conv_last")


def _ptrs(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (void* const*)."""
    return (_P * len(tensors))(*(t.data_ptr() for t in tensors))


# Faults chip_smoke.py plants in kernels 4-6 (`plant`, a bit mask; 0 in
# use): the last stage's residual dropped, the first two stages swapped
# (see sr_kernels.cu launch_chain; on the tensor-core route of kernels 4
# and 5, ops/dense_trunk.prologue_launches / epilogue_launches plant them
# in their launch sequences).
PLANT_NO_RESIDUAL, PLANT_SWAP_STAGES = 1, 2


def dense_prologue(x_raw: torch.Tensor, head_w, weights, ws: torch.Tensor,
                   out: torch.Tensor, head: torch.Tensor,
                   plant: int = 0) -> None:
    """One cooperative launch of kernel 4 off the tensor-core route
    (sr_kernels.cu conv_chain_kernel): head = conv_first(x_raw), out =
    dense block 0 of head. head_w: (kernel, bias) of conv_first; weights:
    the block's five (kernel, bias); ws [B,H,W,4g] scratch."""
    lib = library()
    b, h, w, cin = x_raw.shape
    pairs = [head_w, *weights]
    rc = lib.sr_dense_prologue(
        _ptr(x_raw), cin, _ptrs([k for k, _ in pairs]),
        _ptrs([bb for _, bb in pairs]), _ptr(ws), _ptr(out), _ptr(head), b,
        h, w, out.shape[-1], ws.shape[-1] // 4, plant, _stream(x_raw))
    _check(lib, rc, "sr_dense_prologue")


def dense_epilogue(x: torch.Tensor, weights, residual: torch.Tensor,
                   trunk_w, head: torch.Tensor, ws: torch.Tensor,
                   feat: torch.Tensor, out: torch.Tensor,
                   plant: int = 0) -> None:
    """One cooperative launch of kernel 5 off the tensor-core route
    (sr_kernels.cu conv_chain_kernel): out = trunk_conv(residual + 0.2 *
    block(x)) + head, the block's output in feat; ws [B,H,W,4g] and feat
    [B,H,W,C] scratch."""
    lib = library()
    b, h, w, c = x.shape
    pairs = [*weights, trunk_w]
    rc = lib.sr_dense_epilogue(
        _ptr(x), _ptr(residual), _ptr(head), _ptrs([k for k, _ in pairs]),
        _ptrs([bb for _, bb in pairs]), _ptr(ws), _ptr(feat), _ptr(out), b,
        h, w, c, ws.shape[-1] // 4, plant, _stream(x))
    _check(lib, rc, "sr_dense_epilogue")


def rrdb(x: torch.Tensor, weights, ws: torch.Tensor, tmp: torch.Tensor,
         out: torch.Tensor, plant: int = 0) -> None:
    """One cooperative launch of kernel 6: out = x + 0.2 * block3(block2(
    block1(x))); weights: the three blocks' 15 (kernel, bias) pairs; ws
    [B,H,W,4g] and tmp [B,H,W,C] scratch."""
    lib = library()
    b, h, w, c = x.shape
    rc = lib.sr_rrdb(_ptr(x), _ptrs([k for k, _ in weights]),
                     _ptrs([bb for _, bb in weights]), _ptr(ws), _ptr(tmp),
                     _ptr(out), b, h, w, c, ws.shape[-1] // 4, plant,
                     _stream(x))
    _check(lib, rc, "sr_rrdb")


# The fault chip_smoke.py plants in kernel 6's tensor-core launch
# (`plant`, a bit mask; 0 in use; see dense_kernels.cu): no grid barrier
# between stages.
PLANT_NO_BARRIER = 4


def rrdb_tc(x: torch.Tensor, weights, ws: torch.Tensor, tmp: torch.Tensor,
            out: torch.Tensor, plant: int = 0) -> None:
    """One cooperative launch of kernel 6 on the tensor cores
    (dense_kernels.cu rrdb_tc_kernel, the DenseConv tile body in
    persistent blocks): out = x + 0.2 * block3(block2(block1(x))), every
    tensor bf16 NHWC; weights: the three blocks' 15 (kernel, bias) pairs;
    ws [B,H,W,4g] and tmp [B,H,W,C] scratch."""
    lib = library()
    b, h, w, c = x.shape
    rc = lib.dense_rrdb(_ptr(x), _ptrs([k for k, _ in weights]),
                        _ptrs([bb for _, bb in weights]), _ptr(ws), _ptr(tmp),
                        _ptr(out), b, h, w, c, ws.shape[-1] // 4, plant,
                        _stream(x))
    _check(lib, rc, "dense_rrdb")


def layernorm(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
              out: torch.Tensor, c_real: int | None = None) -> None:
    """One launch of layernorm_kernel (hat_kernels.cu) over the rows of
    x [..., C] bf16; s, b: [C] f32; the statistics divided by c_real
    (default C)."""
    lib = library()
    c = x.shape[-1]
    rc = lib.hat_layernorm(_ptr(x), x.numel() // c, c, c_real or c, _ptr(s),
                           _ptr(b), _ptr(out), _stream(x))
    _check(lib, rc, "hat_layernorm")


# hab_block's weights (ops/hab.hab_weights), in the order hat_hab_block
# and hat_strip_hab read them; they read the dense ones packed in fragment
# order (ops/hab.mma_weights), under the names of HAB_KERNEL_WEIGHTS
HAB_WEIGHTS = ("ln1_s", "ln1_b", "wqkv", "bqkv", "rpb", "wp", "bp", "ln2_s",
               "ln2_b", "w1", "b1", "w2", "b2")
HAB_DENSE = ("wqkv", "wp", "w1", "w2")
HAB_KERNEL_WEIGHTS = tuple(k + "_mma" if k in HAB_DENSE else k
                           for k in HAB_WEIGHTS)

# Faults chip_smoke.py plants in kernels 8 and 11 (`plant`, a bit mask; 0
# in use; see hat_kernels.cu): the first k-step (16 input channels) of
# the q, k and v GEMMs skipped; fc1 fed x1 in place of LN2(x1).
PLANT_SKIP_SLAB, PLANT_NO_LN2 = 8, 16


def hab_block(x: torch.Tensor, cab: torch.Tensor, weights: dict,
              num_heads: int, region_ids: torch.Tensor | None,
              out: torch.Tensor, c_real: int | None = None,
              plant: int = 0) -> None:
    """One launch of kernel 8, hab_kernel (hat_kernels.cu, on the tensor
    cores): x, cab, out [nb, n, C] bf16; weights by HAB_KERNEL_WEIGHTS
    (ops/hab.hab_weights, the dense kernels packed by mma_weights);
    region_ids [nW_img, n] int32 or None; both LNs divided by c_real
    (default C)."""
    lib = library()
    nb, n, c = x.shape
    rc = lib.hat_hab_block(
        _ptr(x), _ptr(cab), _ptr(out), nb, c, num_heads, n,
        weights["w1"].shape[-1],
        _ptrs([weights[k] for k in HAB_KERNEL_WEIGHTS]), _ptr(region_ids),
        0 if region_ids is None else region_ids.shape[0],
        float(c // num_heads) ** -0.5, c_real or c, plant, _stream(x))
    _check(lib, rc, "hat_hab_block")


# Faults chip_smoke.py plants in kernel 11 (`plant`, a bit mask; 0 in
# use; see hat_kernels.cu): its coordinates clamped instead of wrapped,
# its SE scale not applied, its region mask off.
PLANT_CLAMP, PLANT_NO_SE, PLANT_NO_MASK = 1, 2, 4


def strip_hab(x: torch.Tensor, cab_y: torch.Tensor, se: torch.Tensor,
              weights: dict, num_heads: int, ws: int, shift: int,
              out: torch.Tensor, plant: int = 0) -> None:
    """One launch of kernel 11, hab_kernel on the maps (hat_kernels.cu, on
    the tensor cores): x, cab_y, out [B, H, W, C] bf16; se [B, 1, C] f32;
    weights by HAB_KERNEL_WEIGHTS."""
    lib = library()
    b, h, w, c = x.shape
    rc = lib.hat_strip_hab(
        _ptr(x), _ptr(cab_y), _ptr(se), _ptr(out), b, h, w, c, num_heads,
        ws, shift, weights["w1"].shape[-1],
        _ptrs([weights[k] for k in HAB_KERNEL_WEIGHTS]),
        float(c // num_heads) ** -0.5, plant, _stream(x))
    _check(lib, rc, "hat_strip_hab")


# Faults chip_smoke.py plants in the one-launch CAB body of kernels 7
# and 12 (`plant`, a bit mask; 0 in use; see cab_kernels.cu): pixels
# outside the image staged as LN(0) = ln bias, the hidden map not zeroed
# outside the image, a 1-pixel halo (the staged tile's outer ring read as
# zero), each stored column's x XOR 1 (the pixels of a pair swapped;
# kernel 12's fault).
PLANT_CAB_LN_BORDER, PLANT_CAB_HID_BORDER, PLANT_CAB_HALO1 = 1, 2, 4
PLANT_CAB_SWAP_PAIR = 8


def cab_tc(x: torch.Tensor, weights, out: torch.Tensor,
           hidden: torch.Tensor | None = None, c_real: int | None = None,
           plant: int = 0) -> None:
    """One launch of kernel 7's tensor-core body, cab_tc_kernel
    (cab_kernels.cu): x, out [B, H, W, C] bf16; weights as ops/hab.
    cab_mma_weights gives them ([ln_s, ln_b, k1, b1, k2, b2, k1_mma,
    k2_mma]: the kernel reads the packed k1_mma, k2_mma); hidden [B, H, W,
    mid] or None; LN divided by c_real (default C)."""
    lib = library()
    b, h, w, c = x.shape
    ln_s, ln_b, k1, b1, _, b2, w1, w2 = weights
    rc = lib.cab_tc(_ptr(x), b, h, w, c, k1.shape[-1], c_real or c,
                    _ptr(ln_s), _ptr(ln_b), _ptr(w1), _ptr(b1), _ptr(w2),
                    _ptr(b2), _ptr(out), _ptr(hidden), plant, _stream(x))
    _check(lib, rc, "cab_tc")


# Faults chip_smoke.py plants in kernel 9 (`plant`, a bit mask; 0 in use;
# see flash_tc.cuh): the padded keys masked out of the softmax, the
# output not rescaled when a key tile raises the row max, the map rows
# addressed at the wrong stride.
PLANT_PAD_MASKED, PLANT_NO_RESCALE, PLANT_ROW_STRIDE = 1, 2, 4


def oca(q: torch.Tensor, k_map: torch.Tensor, v_map: torch.Tensor,
        bias: torch.Tensor, num_heads: int, ws: int, ows: int,
        grid: tuple[int, int, int], out: torch.Tensor,
        plant: int = 0) -> None:
    """One launch of kernel 9 (oca_kernels.cu, flash_tc.cuh's body over the
    padded maps): q, out [nb, n, C]; k_map, v_map [B, hp, wp, C] bf16;
    bias the f32 [nh, n, ows*ows] / hd^-1/2 in fragment order
    (ops/flash_oca.bias_fragments); grid = (B, window rows, window
    columns)."""
    lib = library()
    b, nh_w, nw_w = grid
    _, hp, wp, c = k_map.shape
    rc = lib.hat_oca(_ptr(q), _ptr(k_map), _ptr(v_map), _ptr(bias),
                     _ptr(out), b, nh_w, nw_w, hp, wp, c, num_heads, ws,
                     ows, float(c // num_heads) ** -0.5, plant, _stream(q))
    _check(lib, rc, "hat_oca")


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, region_ids: torch.Tensor | None,
                     num_heads: int, scale: float, vec: bool,
                     out: torch.Tensor) -> None:
    """One launch of attn_kernel (attn_kernels.cu, kernel 10's CUDA-core
    form, f32): q [nb, n, C], k/v [nb, m, C] f32, each with a unit channel
    stride and any window and row strides; bias [nh, n, m] f32 and
    region_ids [nW_img, n] int32 contiguous; out [nb, n, C] contiguous
    f32. vec: every row of q, k and v starts 4-element aligned."""
    lib = library()
    nb, n, c = q.shape
    rc = lib.attn_window(
        _ptr(q), q.stride(0), q.stride(1), _ptr(k), k.stride(0), k.stride(1),
        _ptr(v), v.stride(0), v.stride(1), _ptr(bias), _ptr(region_ids),
        0 if region_ids is None else region_ids.shape[0], _ptr(out), nb, n,
        k.shape[1], c, num_heads, scale, int(vec), _stream(q))
    _check(lib, rc, "attn_window")


def window_attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        fragments: torch.Tensor,
                        region_ids: torch.Tensor | None, num_heads: int,
                        scale: float, out: torch.Tensor) -> None:
    """One launch of kernel 10 on the tensor cores over windows
    (attn_tc_kernels.cu attn_window_tc, flash_tc.cuh's body): q [nb, n, C],
    k/v [nb, m, C] bf16, each with a unit channel stride and window and
    row strides that keep every row 16-byte (head dim 16) or 8-byte (20)
    aligned; fragments the f32 bias / scale in fragment order
    (ops/flash_oca.bias_fragments); region_ids [nW_img, n] int32
    contiguous or None; out [nb, n, C] contiguous bf16."""
    lib = library()
    nb, n, c = q.shape
    rc = lib.attn_window_tc(
        _ptr(q), q.stride(0), q.stride(1), _ptr(k), k.stride(0), k.stride(1),
        _ptr(v), v.stride(0), v.stride(1), _ptr(fragments), _ptr(region_ids),
        0 if region_ids is None else region_ids.shape[0], _ptr(out), nb, n,
        k.shape[1], c, num_heads, scale, _stream(q))
    _check(lib, rc, "attn_window_tc")


# Faults chip_smoke.py plants in kernel 10 (`plant`, a bit mask; 0 in use;
# map form at C 96, 6 heads, ws 8 only; see flash_tc.cuh): the Swin mask
# dropped, the shifted address clamped to the map instead of wrapped, the
# last key tile skipped.
PLANT_ATTN_NO_MASK, PLANT_ATTN_CLAMP, PLANT_ATTN_SKIP_LAST = 1, 2, 4


def map_attention(qkv: torch.Tensor, fragments: torch.Tensor,
                  num_heads: int, ws: int, shift: int, out: torch.Tensor,
                  plant: int = 0) -> None:
    """One launch of kernel 10 on the tensor cores over the map
    (attn_tc_kernels.cu attn_map_tc): qkv [B, H, W, 3C] and out [B, H, W, C]
    contiguous bf16; the ws x ws windows of the map rolled by -shift;
    fragments as window_attention_tc's."""
    lib = library()
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    rc = lib.attn_map_tc(_ptr(qkv), _ptr(out), _ptr(fragments), b, h, w, c,
                         num_heads, ws, shift, float(c // num_heads) ** -0.5,
                         plant, _stream(qkv))
    _check(lib, rc, "attn_map_tc")


PLANT_SWAP_IJ, PLANT_CLAMP_BORDER, PLANT_NO_BIAS = 1, 2, 3


def conv3x3_d2s(x: torch.Tensor, wk: torch.Tensor, bias: torch.Tensor | None,
                r: int, out: torch.Tensor, tc: bool, plant: int = 0) -> None:
    """One launch of kernel 15, the conv engine's Subpixel policy
    (subpixel_kernels.cu): x [B, C_in, H, W] with any strides (tc: bf16,
    channels-last); wk the K-major [9*C_in, ldw] in x's type and bias
    [ldw] f32 (or None), both contiguous (ops/subpixel.kmajor_weights);
    out contiguous [B, H*r, W*r, C_out] in x's type. tc: the tensor-core
    body, else the direct body."""
    lib = library()
    b, cin, h, w_ = x.shape
    rc = lib.subpixel_conv3x3_d2s(
        _ptr(x), *x.stride(), b, h, w_, cin, _ptr(wk), wk.shape[1],
        _ptr(bias), out.shape[-1], r, _ptr(out),
        int(x.dtype == torch.float32), int(tc), plant, _stream(x))
    _check(lib, rc, "subpixel_conv3x3_d2s")


def star_l1_value(p: torch.Tensor, t: torch.Tensor, threshold: float,
                  weight: float, out: torch.Tensor) -> None:
    """One launch of kernel 14's forward (train_kernels.cu
    star_l1_fwd_kernel): out [1] f32 = mean(|p - t| * (t > threshold ?
    weight : 1)) over p, t (f32, same numel). Launches on one device share
    the kernel's ticket, so they run on one stream at a time."""
    lib = library()
    n = p.numel()
    part = torch.empty(lib.train_star_l1_parts(n), dtype=torch.float32,
                       device=p.device)
    rc = lib.train_star_l1_value(_ptr(p), _ptr(t), n, threshold, weight,
                                 _ptr(part), _ptr(out), _stream(p))
    _check(lib, rc, "train_star_l1_value")


def star_l1_grad(p: torch.Tensor, t: torch.Tensor, threshold: float,
                 weight: float, g: torch.Tensor, dp: torch.Tensor) -> None:
    """One launch of kernel 14's backward: dp = sign(p - t) * w(t) * g / n,
    with the upstream gradient g [1] f32 read on the card."""
    lib = library()
    rc = lib.train_star_l1_grad(_ptr(p), _ptr(t), p.numel(), threshold,
                                weight, _ptr(g), _ptr(dp), _stream(p))
    _check(lib, rc, "train_star_l1_grad")


def dense_scale(src: torch.Tensor, scale: float, out: torch.Tensor) -> None:
    """One launch of dense_scale_kernel: out[..., :c] = scale * src,
    rounded once, for src [B,H,W,c] and out [B,H,W,>=c], both bf16 or
    both f32."""
    lib = library()
    c = src.shape[-1]
    rc = lib.train_dense_scale(_ptr(src), src.numel() // c, c, scale,
                               _ptr(out), out.shape[-1],
                               int(src.dtype == torch.float32), _stream(src))
    _check(lib, rc, "train_dense_scale")


def grad_conv(d: torch.Tensor, n_in: int, wk: torch.Tensor,
              out: torch.Tensor, out_off: int, *,
              gate: torch.Tensor | None = None, gate_off: int = 0,
              add: torch.Tensor | None = None, add_scale: float = 1.0,
              seg: tuple[int, int] | None = None, seg_plant: int = 0) -> None:
    """One launch of a transposed conv of kernel 13 on the conv engine
    (train_tc_kernels.cu, the DenseGradConv policy):
    out[..., out_off:out_off + n] = epilogue(conv3x3_SAME(d[..., :n_in],
    wk)) for the flipped K-major weights wk [9 * n_in, n] (or their HWIO
    [3, 3, n_in, n] view). The epilogue: v = gate[..., gate_off + o] > 0 ?
    v : 0.2 v when a gate is given, then v += add_scale * add, in f32, one
    rounding. d, out, gate, add NHWC of one [B,H,W]; d may be out (its
    channels n_in .. stay disjoint from out_off ..). seg and seg_plant as
    conv3x3's. Every tensor bf16 (the tensor-core body) or every one f32
    (the direct body); raises on others."""
    f32 = activation_dtype(d, "grad_conv") == torch.float32
    require_cuda(d, wk, out, gate, add, dtype=d.dtype, name="grad_conv")
    lib = library()
    b, h, wd = d.shape[:3]
    n = wk.shape[-1]
    stride, valid = seg or (0, 0)
    gate_ptr = None if gate is None else (
        gate.data_ptr() + gate_off * gate.element_size())
    rc = lib.train_grad_conv(
        _ptr(d), b, h, wd, d.shape[-1], n_in, _ptr(wk), _ptr(out),
        out.shape[-1], out_off, n, gate_ptr,
        0 if gate is None else gate.shape[-1], _ptr(add),
        0 if add is None else add.shape[-1], add_scale, stride, valid,
        seg_plant, int(f32), _stream(d))
    _check(lib, rc, "train_grad_conv")


def flip_weights(weights, out: torch.Tensor) -> None:
    """One launch of flip_weights_kernel (train_tc_kernels.cu): out, bf16
    with room for all five, receives the transposed convs' K-major
    weights of sources 4, 3, 2, 1 and 0 one after another
    (ops/dense_trunk_train.flipped_weights of each, flattened). Raises
    unless the kernels and out are bf16."""
    require_cuda(out, *(k for k, _ in weights), name="flip_weights")
    lib = library()
    c = weights[4][0].shape[-1]
    g = weights[0][0].shape[-1]
    rc = lib.train_flip_weights(_ptrs([k for k, _ in weights]), c, g,
                                _ptr(out), _stream(out))
    _check(lib, rc, "train_flip_weights")


def wgrad(in0: torch.Tensor, cin0: int, in1: torch.Tensor | None, cin1: int,
          d: torch.Tensor, d_off: int, cout: int, dw: torch.Tensor,
          db: torch.Tensor | None,
          seg: tuple[int, int] | None = None) -> None:
    """Two launches (wgrad_kernel, wgrad_reduce_kernel): the weight grad
    dw [3,3,cin0+cin1,cout] of a 3x3 SAME conv whose input
    is [in0[..., :cin0], in1[..., :cin1]] and whose output cotangent is
    d[..., d_off:d_off+cout], and its bias grad db [cout] f32 if given.
    dw has the weight's type, bf16 or f32, as have all activations (NHWC,
    of one [B,H,W] geometry). seg = (stride, valid): spacer rows of the
    input and of d read as zero (see conv3x3)."""
    _wgrad_launch("train_wgrad", in0, cin0, in1, cin1, d, d_off, cout, dw,
                  db, seg, f32=in0.dtype == torch.float32)


def wgrad_tc(in0: torch.Tensor, cin0: int, in1: torch.Tensor | None,
             cin1: int, d: torch.Tensor, d_off: int, cout: int,
             dw: torch.Tensor, db: torch.Tensor | None,
             seg: tuple[int, int] | None = None) -> None:
    """wgrad's two launches with wgrad_tc_kernel (train_tc_kernels.cu, bf16
    mma.sync, f32 sums) in place of wgrad_kernel: per-chunk f32 partials
    summed in a fixed order by wgrad_reduce_kernel. Every activation and
    dw bf16, db f32; raises on others."""
    require_cuda(in0, in1, d, dw, name="wgrad_tc")
    require_cuda(db, dtype=torch.float32, name="wgrad_tc")
    _wgrad_launch("train_wgrad_tc", in0, cin0, in1, cin1, d, d_off, cout,
                  dw, db, seg)


def _wgrad_launch(name: str, in0, cin0, in1, cin1, d, d_off, cout, dw, db,
                  seg, f32: bool | None = None) -> None:
    """The launches of `name` (train_wgrad or train_wgrad_tc), with the
    chunk count its `name`_chunks picks; f32: train_wgrad's type flag
    (None for train_wgrad_tc, which takes none)."""
    lib = library()
    b, h, w = in0.shape[:3]
    cin = cin0 + cin1
    nchunk = getattr(lib, name + "_chunks")(b, h, w, cin, cout)
    part = torch.empty(nchunk * (9 * cin * cout + cout), dtype=torch.float32,
                       device=in0.device)
    rc = getattr(lib, name)(
        _ptr(in0), in0.shape[-1], cin0,
        _ptr(in1), 0 if in1 is None else in1.shape[-1], cin1,
        d.data_ptr() + d_off * d.element_size(), d.shape[-1], cout,
        b, h, w, *(seg or (0, 0)), nchunk, _ptr(part), _ptr(dw), _ptr(db),
        *(() if f32 is None else (int(f32),)), _stream(in0))
    _check(lib, rc, name)


# Faults chip_smoke.py plants in kernels 16-19 (`plant`, a bit mask; 0 in
# use; see dense_valid_kernels.cu, extra_kernels.cu and pack_kernels.cu):
# 16's intermediates zeroed outside the image (SAME semantics) or its 0.2
# residual scale dropped (both in either body); 17 normalized by
# the binomial row's sum or missing its top-left tap; 18's pad packs not
# zeroed or the left tap across a pack edge dropped (both in either
# body); 19's last band not stored (stream_kernels.cu).
PLANT_SAME, PLANT_NO_SCALE = 1, 2
PLANT_NORM, PLANT_CORNER = 1, 2
PLANT_PAD_KEPT, PLANT_DROP_CROSS = 1, 2
PLANT_LAST_BAND = 1


def dense_valid_stage(x: torch.Tensor, ws: torch.Tensor, out: torch.Tensor,
                      mats, bias: torch.Tensor, j: int,
                      plant: int = 0) -> None:
    """One launch of kernel 16's stage j (1..5) on the conv engine's
    direct body, conv_kernel<DenseStage> (dense_valid_kernels.cu): x, out
    [B,H,W,c]; ws [B,H+8,W+8,4g]; mats the five tap-major matrices (wx,
    w1..w4), all in x's type (bf16 or f32); bias [4g+c] f32."""
    lib = library()
    b, h, w, c = x.shape
    rc = lib.dense_valid_stage(
        _ptr(x), _ptr(ws), _ptr(out), _ptrs(mats), _ptr(bias), b, h, w, c,
        ws.shape[-1] // 4, j, int(x.dtype == torch.float32), plant,
        _stream(x))
    _check(lib, rc, "dense_valid_stage")


def dense_valid_tc(x: torch.Tensor, ws: torch.Tensor, out: torch.Tensor,
                   wk: torch.Tensor, bias: torch.Tensor, j: int,
                   plant: int = 0) -> None:
    """One launch of kernel 16's stage j (1..5) on the conv engine's
    tensor-core body, conv_tc_kernel<DenseStage<bf16>, BN>
    (dense_valid_kernels.cu): x, out [B,H,W,c] and ws [B,H+8,W+8,4g]
    bf16; wk stage j's K-major weights (ops/dense_valid.
    pack_stage_weights) bf16; bias [4g+c] f32."""
    lib = library()
    b, h, w, c = x.shape
    rc = lib.dense_valid_stage_tc(
        _ptr(x), _ptr(ws), _ptr(out), _ptr(wk), _ptr(bias), b, h, w, c,
        ws.shape[-1] // 4, j, plant, _stream(x))
    _check(lib, rc, "dense_valid_stage_tc")


def blur(x: torch.Tensor, size: int, norm: float, out: torch.Tensor,
         plant: int = 0) -> None:
    """One launch of kernel 17, blur_kernel (extra_kernels.cu): out = the
    depthwise SAME blur of x [B,H,W,C] (bf16 or f32) by the size x size
    binomial / norm."""
    lib = library()
    b, h, w, c = x.shape
    rc = lib.extra_blur(_ptr(x), _ptr(out), b, h, w, c, size, norm,
                        int(x.dtype == torch.float32), plant, _stream(x))
    _check(lib, rc, "extra_blur")


def pack_conv(xp: torch.Tensor, wk: torch.Tensor, bias: torch.Tensor,
              out: torch.Tensor, p: int, width: int, lrelu: bool, tc: bool,
              plant: int = 0) -> None:
    """One launch of kernel 18, the conv engine's PackConv policy
    (pack_kernels.cu): xp [B,H,W2,p*c], wk the K-major [9c, n] in xp's
    type (bf16 or f32; ops/pairconv.kmajor_weights), bias [n] f32, out
    [B,H,W2,p*n]; the real pixels are columns [p, p + width) of the
    unpacked [B,H,W2*p,*] view. tc: the tensor-core body, else the
    direct body."""
    lib = library()
    b, h, w2, pc = xp.shape
    c, n = wk.shape[0] // 9, wk.shape[1]
    rc = lib.extra_pack_conv(
        _ptr(xp), _ptr(wk), _ptr(bias), _ptr(out), b, h, w2 * p, c, n, p,
        width, int(lrelu), int(xp.dtype == torch.float32), int(tc), plant,
        _stream(xp))
    _check(lib, rc, "extra_pack_conv")


def stream_copy(src: torch.Tensor, dst: torch.Tensor, blocks: int,
                band_bytes: int, plant: int = 0) -> None:
    """One launch of kernel 19, copy_kernel (stream_kernels.cu): dst =
    src on `blocks` = utils/dma_probe.copy_grid(bytes), one block a 16 KB
    chunk (the launch fails on another grid); bytes and band_bytes
    multiples of 16. PLANT_LAST_BAND leaves the last band_bytes of dst
    unwritten."""
    lib = library()
    nbytes = src.numel() * src.element_size()
    rc = lib.stream_copy(_ptr(src), _ptr(dst), nbytes, blocks, band_bytes,
                         plant, _stream(src))
    _check(lib, rc, "stream_copy")


def noop(t: torch.Tensor) -> None:
    """One launch of an empty kernel on t's device and stream, through the
    same ctypes path as the kernels: the floor under a launch."""
    lib = library()
    _check(lib, lib.extra_noop(_stream(t)), "extra_noop")
