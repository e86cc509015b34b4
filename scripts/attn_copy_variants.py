"""Time variants of kernel 9 (flash_kernel's KEYS_OCA instances,
ops/csrc/flash_tc.cuh via oca_kernels.cu), kernel 8 (hab_kernel,
ops/csrc/hat_kernels.cu) and kernel 19 (copy_kernel,
ops/csrc/stream_kernels.cu) on one GPU.

Each variant is the kernel's source (with the headers it includes) under
a few text edits, built by nvcc into its own library beside the port's
own build and called through the same C entry point; kernel 9's body
edits go to flash_tc.cuh, which kernel 10's bf16 launches share.
Every variant is checked against the plain version (its max |err| / max
|plain| is printed; large for the floors, which skip work).

Kernel 9's variants are timed with CUDA events at the hybrid's
[1024, 64, 96] ows 12 and the h200 class's [256, 256, 96] and
[256, 256, 120] ows 24, beside
F.scaled_dot_product_attention on the pre-gathered windows:
  kt16, kt48    key tiles of 16 or 48 keys in place of 32
  nstage2       a ring of 2 stages (1 tile in flight) in place of 3
  nstage4       a ring of 4 stages
  cta2          2 blocks a ws 16 window in place of 4 (128 queries a
                block; ws 8 is one block a window anyway)
  ppw2, ppw1    2 or 1 (head, query tile) pairs a warp in place of 3 at
                head dim 16 (12 or 24 warps a block at 6 heads, 16 or 32
                at 8; one block an SM)
  hd20_ppw2     2 pairs a warp at head dim 20 in place of 1 (12 warps)
  hd20_ppw3     3 pairs a warp at head dim 20 (8 warps, two blocks an SM)
  hd20_ppw3_kt16  the same with key tiles of 16
  one_block     3 pairs a warp, one block an SM (no register cap of 128)
  pair_fence    a compiler fence before each pair, so no pair's loads
                are hoisted above the one before
  expf          expf((s - m) ln 2) in place of ex2.approx(s - m) (the
                logits are in log2 units)
  bias_raw      the bias / scale read as it lies, two 8-byte loads a lane
                and key tile, in place of one 16-byte load in fragment
                order (the script passes it so)
  no_bias       the bias not read (a floor: what the 4 bytes a logit
                from L2 cost)
  no_softmax    p = the scaled logit, no exponential (a floor)
  stream_only   the keys staged and the output written, no attention (a
                floor)
  plants_c120   at C 120 the instance that takes the planted faults (its
                plant code in the body, plant 0) in place of the path's
Kernel 8's variants are timed at the hybrid's [1024, 64, 96] (8 x 8
windows, 6 heads, MLP 192) and the lane-padded [1024, 64, 128] (8 heads,
c_real 96), both with the Swin mask; they bound what staging its weights
in shared memory (a cp.async ring of K-slabs) could save at n 64:
  w_l1         every weight fragment read from the first k-step's
               (one more multiply a load), so every load after the
               first hits L1: the time of the GEMMs with the weights'
               L2 traffic and most of their latency gone (a floor for any
               staging of them; the output is wrong)
  no_w         no weight loads at all (the fragments made from the lane
               index; a floor)
  w_unroll4    the GEMMs' k-step loop unrolled by 4 in place of 2 (more
               weight loads in flight a warp)
and `k10_shape` times the kernel at kernel 10's upscale shape, q
[41472, 64, 96] against 144 keys a window, beside kernel 10's window
form (the same body on KEYS_WIN, attn_tc_kernels.cu) on the same windows
pre-gathered.

Kernel 19's variants are timed at dma_probe's two shapes in bf16 beside
dst.copy_(src), each span's calls queued behind a spin of the card
(dma_probe.copy_ms):
  tma          the TMA ring engine (TMA_SRC) in place of the registers
  nc_cs        non-coherent loads and evict-first stores (ld.global.nc,
               st.global.cs) in place of plain ones
  l2_256b      loads that ask L2 for 256-byte sectors
               (ld.global.nc.L2::256B)
  threads512, threads256  512 threads with 2 words a thread in flight,
               or 256 with 4, in place of 1024 with 1 (the same 16 KB a
               block)
  every_8k, every_32k, every_64k, every_128k  a block for every 8 KB
               (512 threads), or 32, 64 or 128 KB (2, 4 or 8 words a
               thread), in place of 16 KB
  persist1x, persist2x, persist4x  a persistent grid of 1x, 2x or 4x
               the SMs dealing 8 KB chunks round-robin, 4 loads in
               flight a thread (PERSIST_SRC in place of copy_kernel)
  persist2x_64k  the same over 2x the SMs with 64 KB chunks
  one_run      2x the SMs, one run of about bytes / blocks a block

Usage (one GPU, nvcc as for the port's build), from the repo's root:
  python -m scripts.attn_copy_variants [variant ...]
Prints the card, each variant's registers and spills, and one line a
shape with the milliseconds of `main` (the sources as they are), each
variant and the library call.
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
from superresolution_tpu_torch.ops import flash_oca as fo
from superresolution_tpu_torch.ops import hab
from superresolution_tpu_torch.ops.unfold import extract_overlapping_windows
from superresolution_tpu_torch.utils import dma_probe as dp
from superresolution_tpu_torch.utils.conv_engine_variants import (
    rel_err,
    time_ms,
    with_library,
)

OCA = "oca_kernels.cu"
HAB = "hat_kernels.cu"
W_LOAD = ("const uint2 bw = __ldg(W + ((size_t)ks * NFT + j0 + j) * 32 + "
          "lane);")
FLASH = "flash_tc.cuh"           # kernel 9's body, built through OCA
COPY = "stream_kernels.cu"
NEVER = "a.plant == 0x7fff"      # no check plants this
BIAS = "__ldg(bfrag + n * 32)"
EXP_P = "s[n][e] = ce::exp2_approx(s[n][e] + mneg[e >> 1]);"
LN2 = "0.6931471805599453f"
PAIR0 = "      const int h = h0 + pp * G::HSTEP, row = q0 + qr + g;"
PAIRS = "    for (int pp = 0; pp < PPW; ++pp) {\n" + PAIR0
# The TMA ring engine the tma variant builds in place of copy_kernel: one
# thread a block moves its chunks through shared memory by bulk copies,
# global to shared under an mbarrier, shared to global in bulk groups.
TMA_SRC = r"""// ---- the TMA ring engine (a variant) ----

constexpr int COPY_STAGES = 4;           // the ring
constexpr int COPY_STAGE_BYTES = 16384;

// Bulk copy (the TMA unit) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory, which completes `bytes`
// of the transaction count of the mbarrier at `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on the mbarrier at `bar` and expects `bytes` more of transfer.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the mbarrier at `bar` has completed the phase of `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Closes this thread's current bulk group; waits until at most N of its
// groups have not finished reading their shared source (bulk_pending_read)
// or have not completed (bulk_pending).
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_pending_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_pending() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same partition through a TMA ring: one thread moves the block's
// chunks in pieces of at most COPY_STAGE_BYTES, COPY_STAGES in flight.
__global__ void __launch_bounds__(32) copy_tma_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst, long long words,
    long long chunk, long long keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[COPY_STAGES];
  if (threadIdx.x != 0) return;
  constexpr long long PIECE = COPY_STAGE_BYTES / 16;  // words a stage
  for (int s = 0; s < COPY_STAGES; ++s)
    mbar_init(ce::smem_u32(&bar[s]), 1);
  // the block's pieces in order: chunk c, piece p of it
  const long long stride = (long long)gridDim.x * chunk;
  const long long per_chunk = (chunk + PIECE - 1) / PIECE;
  auto piece = [&](long long k, long long& w0, long long& n) {
    const long long c0 = blockIdx.x * chunk + (k / per_chunk) * stride;
    w0 = c0 + (k % per_chunk) * PIECE;
    const long long c1 = c0 + chunk < words ? c0 + chunk : words;
    n = w0 < c1 ? (c1 - w0 < PIECE ? c1 - w0 : PIECE) : 0;
  };
  long long npieces = 0;  // pieces until the first empty one
  for (long long w0, n;; ++npieces) {
    piece(npieces, w0, n);
    if (n == 0) break;
  }
  auto load = [&](long long k) {
    long long w0, n;
    piece(k, w0, n);
    const uint32_t b = ce::smem_u32(&bar[k % COPY_STAGES]);
    mbar_expect(b, (uint32_t)(n * 16));
    bulk_load(ce::smem_u32(smem + (k % COPY_STAGES) * COPY_STAGE_BYTES),
                  src + w0, (uint32_t)(n * 16), b);
  };
  for (long long k = 0; k < npieces && k < COPY_STAGES; ++k) load(k);
  for (long long k = 0; k < npieces; ++k) {
    long long w0, n;
    piece(k, w0, n);
    mbar_wait(ce::smem_u32(&bar[k % COPY_STAGES]),
                  (uint32_t)((k / COPY_STAGES) & 1));
    const long long m = w0 + n <= keep ? n : (keep > w0 ? keep - w0 : 0);
    if (m > 0)
      ce::bulk_store(dst + w0,
                     ce::smem_u32(smem + (k % COPY_STAGES) * COPY_STAGE_BYTES),
                     (uint32_t)(m * 16));
    bulk_commit();
    if (k + COPY_STAGES < npieces) {
      bulk_pending_read<0>();  // the stage's store has read it
      load(k + COPY_STAGES);
    }
  }
  bulk_pending<0>();
}

"""
COPY_LAUNCH = """\
  copy_kernel<<<blocks, COPY_THREADS, 0, s>>>(static_cast<const uint4*>(src),
                                              static_cast<uint4*>(dst), words,
                                              keep);"""
TMA_LAUNCH = """\
  const size_t ring = (size_t)COPY_STAGES * COPY_STAGE_BYTES;
  const cudaError_t e = ce::allow_smem<copy_tma_kernel>(ring);
  if (e != cudaSuccess) return (int)e;
  copy_tma_kernel<<<blocks, 32, ring, s>>>(static_cast<const uint4*>(src),
                                            static_cast<uint4*>(dst), words,
                                            COPY_CHUNK, keep);"""
# copy_kernel as built, which the persistent variants replace
COPY_KERNEL = """\
__global__ void __launch_bounds__(COPY_THREADS) copy_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst, long long words,
    long long keep) {
  const long long w0 = blockIdx.x * COPY_CHUNK + threadIdx.x;
  uint4 v[COPY_WORDS];
#pragma unroll
  for (int u = 0; u < COPY_WORDS; ++u)
    if (w0 + u * COPY_THREADS < words) v[u] = src[w0 + u * COPY_THREADS];
#pragma unroll
  for (int u = 0; u < COPY_WORDS; ++u)
    if (w0 + u * COPY_THREADS < keep) dst[w0 + u * COPY_THREADS] = v[u];
}"""
COPY_LOAD = "v[u] = src[w0 + u * COPY_THREADS];"
COPY_STORE = "dst[w0 + u * COPY_THREADS] = v[u];"
GRID_CHECK = """\
  if (blocks != (words + COPY_CHUNK - 1) / COPY_CHUNK)
    return (int)cudaErrorInvalidValue;"""
# A persistent grid: block b copies chunks c = b, b + grid, ... of CHUNK
# words, 4 of its COPY_THREADS-word steps in flight (loads, then stores).
PERSIST_SRC = """\
__global__ void __launch_bounds__(COPY_THREADS) copy_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst, long long words,
    long long keep) {
  const long long chunk = CHUNK;
  const long long nchunks = (words + chunk - 1) / chunk;
  if (blockIdx.x >= nchunks) return;
  const long long mine = (nchunks - 1 - blockIdx.x) / gridDim.x + 1;
  const long long steps = (chunk + COPY_THREADS - 1) / COPY_THREADS;
  long long k = 0, st = 0;  // the next step: chunk k of the block, step st
  while (k < mine) {
    uint4 v[4];
    long long at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long off = st * COPY_THREADS + threadIdx.x;
      const long long w = (blockIdx.x + k * gridDim.x) * chunk + off;
      at[u] = k < mine && off < chunk && w < words ? w : -1;
      if (at[u] >= 0) v[u] = src[w];
      if (++st == steps) {
        st = 0;
        ++k;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0 && at[u] < keep) dst[at[u]] = v[u];
  }
}"""


def persist(chunk: str) -> list:
    """The edits of a persistent variant whose chunk (words) is `chunk`,
    on any grid the script passes."""
    return [(COPY_KERNEL, PERSIST_SRC.replace("CHUNK;", chunk + ";")),
            (GRID_CHECK,
             "  if (blocks < 1) return (int)cudaErrorInvalidValue;")]


def words_a_thread(n: int) -> list:
    """The edit of a variant that copies n words a thread."""
    return [("constexpr int COPY_WORDS = 1;",
             f"constexpr int COPY_WORDS = {n};")]


THREADS_512 = ("constexpr int COPY_THREADS = 1024;",
               "constexpr int COPY_THREADS = 512;")


# name: (source, [(old, new), ...])
VARIANTS = {
    "kt16": (FLASH, [("constexpr int KT = 32;", "constexpr int KT = 16;")]),
    "kt48": (FLASH, [("constexpr int KT = 32;", "constexpr int KT = 48;")]),
    "nstage2": (FLASH, [("constexpr int NSTAGE = 3;",
                       "constexpr int NSTAGE = 2;")]),
    "nstage4": (FLASH, [("constexpr int NSTAGE = 3;",
                       "constexpr int NSTAGE = 4;")]),
    "cta2": (FLASH, [("constexpr int NQ_MAX = 64;",
                    "constexpr int NQ_MAX = 128;")]),
    "ppw2": (FLASH, [("constexpr int PPW_CAP = 3;",
                    "constexpr int PPW_CAP = 2;")]),
    "ppw1": (FLASH, [("constexpr int PPW_CAP = 3;",
                    "constexpr int PPW_CAP = 1;")]),
    "hd20_ppw2": (FLASH, [("constexpr int PPW_CAP_HD20 = 1;",
                         "constexpr int PPW_CAP_HD20 = 2;")]),
    "hd20_ppw3": (FLASH, [("constexpr int PPW_CAP_HD20 = 1;",
                         "constexpr int PPW_CAP_HD20 = 3;")]),
    "hd20_ppw3_kt16": (FLASH, [("constexpr int PPW_CAP_HD20 = 1;",
                              "constexpr int PPW_CAP_HD20 = 3;"),
                             ("constexpr int KT = 32;",
                              "constexpr int KT = 16;")]),
    "one_block": (FLASH, [("constexpr int BLOCKS_CAP = 2;",
                         "constexpr int BLOCKS_CAP = 1;")]),
    "pair_fence": (FLASH, [(PAIR0, "      asm volatile(\"\" ::: \"memory\");\n"
                                  + PAIR0)]),
    "expf": (FLASH, [
        ("ce::exp2_approx(mx[r] - mref)",
         f"expf((mx[r] - mref) * {LN2})"),
        (EXP_P, f"s[n][e] = expf((s[n][e] + mneg[e >> 1]) * {LN2});")]),
    "bias_raw": (FLASH, [(BIAS, (
        "[&] { const float* br = reinterpret_cast<const float*>(a.bias) + "
        "((size_t)h * N + row) * M + t * KT + n * 8 + 2 * tig; "
        "const float2 b0 = __ldg(reinterpret_cast<const float2*>(br)); "
        "const float2 b1 = __ldg(reinterpret_cast<const float2*>(br + 8 * "
        "M)); return make_float4(b0.x, b0.y, b1.x, b1.y); }()"))]),
    "no_bias": (FLASH, [(BIAS, "make_float4(0.f, 0.f, 0.f, 0.f)")]),
    "no_softmax": (FLASH, [(EXP_P, "s[n][e] = s[n][e] + mneg[e >> 1];")]),
    "stream_only": (FLASH, [(PAIRS, PAIRS.replace(
        "pp < PPW;", f"pp < PPW && {NEVER};"))]),
    "w_l1": (HAB, [(W_LOAD, W_LOAD.replace("(size_t)ks * NFT",
                                           "(size_t)(ks * first) * NFT"))]),
    "no_w": (HAB, [(W_LOAD, "const uint2 bw = make_uint2(lane, j);")]),
    "w_unroll4": (HAB, [("#pragma unroll 2\n    for (int ks = first;",
                         "#pragma unroll 4\n    for (int ks = first;")]),
    "plants_c120": (OCA, [("return launch_oca<120, 6, 16, 24>(a, nb, s);",
                           "return launch_oca<120, 6, 16, 24, true>(a, nb, "
                           "s);")]),
    "tma": (COPY, [("}  // namespace\n\nextern", TMA_SRC + "}  // namespace"
                    "\n\nextern"), (COPY_LAUNCH, TMA_LAUNCH)]),
    "nc_cs": (COPY, [(COPY_LOAD, "v[u] = __ldg(src + w0 + u * COPY_THREADS);"),
                     (COPY_STORE,
                      "__stcs(dst + w0 + u * COPY_THREADS, v[u]);")]),
    "l2_256b": (COPY, [(COPY_LOAD, (
        "asm volatile(\"ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];\" : \"=r\"(v[u].x), \"=r\"(v[u].y), \"=r\"(v[u].z), "
        "\"=r\"(v[u].w) : \"l\"(src + w0 + u * COPY_THREADS));"))]),
    "threads512": (COPY, [THREADS_512, *words_a_thread(2)]),
    "threads256": (COPY, [("constexpr int COPY_THREADS = 1024;",
                           "constexpr int COPY_THREADS = 256;"),
                          *words_a_thread(4)]),
    "every_8k": (COPY, [THREADS_512]),
    "every_32k": (COPY, words_a_thread(2)),
    "every_64k": (COPY, words_a_thread(4)),
    "every_128k": (COPY, words_a_thread(8)),
    "persist1x": (COPY, persist("512")),
    "persist2x": (COPY, persist("512")),
    "persist4x": (COPY, persist("512")),
    "persist2x_64k": (COPY, persist("4096")),
    "one_run": (COPY, persist("(words + gridDim.x - 1) / gridDim.x")),
}
ENTRY = {OCA: "hat_oca", HAB: "hat_hab_block", COPY: "stream_copy"}
KERNEL = {OCA: "flash_kernel", HAB: "hab_kernel",
          COPY: "copy_kernel|copy_tma_kernel"}
COMPILED = {FLASH: OCA}          # a header's edits build through this
# (tag, C, heads, ws, ows, map side) at the frames' stage-2 shapes
OCA_CASES = (("hybrid_c96_ws8_ows12", 96, 6, 8, 12, 256),
             ("h200_c96_ws16_ows24", 96, 6, 16, 24, 256),
             ("h200_c120_ws16_ows24", 120, 6, 16, 24, 256))
K10_IMAGES, K10_SIDE = 8, 576      # 8 x 72 x 72 = 41472 windows of 64
# (tag, C, heads, MLP, c_real) of kernel 8 at n 64 on 1024 windows (a
# 256^2 map, shift 4)
HAB_CASES = (("hybrid_c96_n64", 96, 6, 192, None),
             ("lane_pad_c128_n64", 128, 8, 192, 96))
# the grid of each copy variant that is not one block a 16 KB chunk, from
# the bytes and the SMs
COPY_GRIDS = {"every_8k": lambda n, sms: -(-n // 8192),
              "every_32k": lambda n, sms: -(-n // 32768),
              "every_64k": lambda n, sms: -(-n // 65536),
              "every_128k": lambda n, sms: -(-n // 131072),
              "persist1x": lambda n, sms: sms,
              "persist2x": lambda n, sms: 2 * sms,
              "persist4x": lambda n, sms: 4 * sms,
              "persist2x_64k": lambda n, sms: 2 * sms,
              "one_run": lambda n, sms: 2 * sms}


def usage(report: str, kernel: str) -> str:
    """`kernel`'s registers and spills, one item an instantiation."""
    out, lines = [], report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(rf"Compiling entry function '\S*?({kernel})(\S*?)'",
                      line)
        if k:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info).group(1)
            spill = re.search(r"(\d+) bytes spill stores", info).group(1)
            args = re.findall(r"L[ib](\d+)E", k.group(2))
            out.append(f"{k.group(1)}<{','.join(args)}> {regs}r/{spill}s")
    return " ".join(out)


def build(name: str, workdir: Path) -> tuple[ctypes.CDLL | None, str]:
    """The variant's library and its ptxas usage (None and the compiler's
    errors where it does not build)."""
    source, edits = VARIANTS[name]
    unit = COMPILED.get(source, source)
    d = workdir / name
    d.mkdir()
    for header in _build.SRC_DIR.glob("*.cuh"):
        shutil.copy(header, d)
    shutil.copy(_build.SRC_DIR / unit, d)
    s = (_build.SRC_DIR / source).read_text()
    for old, new in edits:
        if old not in s:
            raise ValueError(f"{name}: {old!r} not in {source}")
        s = s.replace(old, new)
    (d / source).write_text(s)
    obj, so = str(d / "k.o"), str(d / "lib.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                           str(d / unit), "-o", obj],
                          capture_output=True, text=True)
    if proc.returncode:
        return None, "nvcc failed: " + " ".join(
            line for line in proc.stderr.splitlines() if "error" in line)
    subprocess.run([_build._nvcc(), "-shared", "-o", so, obj], check=True)
    lib = ctypes.CDLL(so)
    main = _build.library()
    fn = ENTRY[unit]
    getattr(lib, fn).argtypes = getattr(main, fn).argtypes
    getattr(lib, fn).restype = getattr(main, fn).restype
    lib.sr_error_string = main.sr_error_string  # in sr_kernels.cu
    return lib, usage(proc.stderr, KERNEL[unit])


def oca_inputs(gen: torch.Generator, c, nh, ws, ows, side, images=1):
    """q, k_map, v_map (bf16, N(0, 1.5^2), maps zero-padded) and bias
    N(0, 1) at `images` maps of side x side."""
    bf = torch.bfloat16
    pad = (ows - ws) // 2
    nw = images * (side // ws) ** 2
    q = (1.5 * torch.randn((nw, ws * ws, c), generator=gen)).to("cuda", bf)
    maps = [F.pad((1.5 * torch.randn((images, side, side, c), generator=gen))
                  .to("cuda", bf), (0, 0, pad, pad, pad, pad)).contiguous()
            for _ in range(2)]
    bias = torch.randn((nh, ws * ws, ows * ows), generator=gen).cuda()
    return q, *maps, bias


def time_oca(libs: dict, gen: torch.Generator) -> None:
    for tag, c, nh, ws, ows, side in OCA_CASES:
        q, k_map, v_map, bias = oca_inputs(gen, c, nh, ws, ows, side)
        ref = fo.flash_oca_gathered_reference(q, k_map, v_map, bias, nh, ws,
                                              ows).float()
        scale = (c // nh) ** -0.5
        frag = fo.bias_fragments(bias, scale)
        raw = (bias / scale).contiguous()
        line = [tag]
        for name, lib in libs.items():
            b_in = raw if name == "bias_raw" else frag
            out = torch.full_like(q, float("nan"))
            grid = (1, side // ws, side // ws)

            def launch():
                _build.oca(q, k_map, v_map, b_in, nh, ws, ows, grid, out)

            with_library(lib, launch)
            ms = with_library(lib, lambda: time_ms(launch, 20))
            line.append(f"{name} {ms:.4f} ms ({rel_err(out, ref):.1e})")
        sq = q.reshape(-1, ws * ws, nh, c // nh).transpose(1, 2)
        kw, vw = (extract_overlapping_windows(m, ws, ows, side // ws,
                                              side // ws)
                  .reshape(-1, ows * ows, nh, c // nh).transpose(1, 2)
                  for m in (k_map, v_map))
        mask = bias.to(torch.bfloat16)
        ms = time_ms(lambda: F.scaled_dot_product_attention(
            sq, kw, vw, attn_mask=mask), 20)
        line.append(f"sdpa {ms:.4f} ms")
        print(" | ".join(line), flush=True)
        del q, k_map, v_map, sq, kw, vw
        torch.cuda.empty_cache()


def hab_inputs(gen: torch.Generator, c, nh, mlp):
    """x, cab [1024, 64, C] bf16, kernel 8's weights packed as a model
    packs them, and the Swin region ids of a 256^2 map at shift 4."""
    from superresolution_tpu_torch.models.hat_lite import shift_region_ids

    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale + shift).to(
            "cuda", dtype)

    w = {"ln1_s": rnd(c, scale=0.1, shift=1.0), "ln1_b": rnd(c, scale=0.1),
         "wqkv": rnd(c, 3 * c, scale=0.15, dtype=bf),
         "bqkv": rnd(3 * c, scale=0.1), "rpb": rnd(nh, 64, 64),
         "wp": rnd(c, c, scale=c ** -0.5, dtype=bf), "bp": rnd(c, scale=0.1),
         "ln2_s": rnd(c, scale=0.1, shift=1.0), "ln2_b": rnd(c, scale=0.1),
         "w1": rnd(c, mlp, scale=c ** -0.5, dtype=bf),
         "b1": rnd(mlp, scale=0.1),
         "w2": rnd(mlp, c, scale=mlp ** -0.5, dtype=bf),
         "b2": rnd(c, scale=0.1)}
    ids = torch.as_tensor(shift_region_ids(256, 256, 8, 4), device="cuda")
    return (rnd(1024, 64, c, dtype=bf), rnd(1024, 64, c, scale=0.3, dtype=bf),
            hab.mma_weights(w), ids)


def time_hab(libs: dict, gen: torch.Generator) -> None:
    for tag, c, nh, mlp, c_real in HAB_CASES:
        x, cab, w, ids = hab_inputs(gen, c, nh, mlp)
        ref = hab.hab_body_reference(x, cab, w, nh, ids, c_real).float()
        line = [tag]
        for name, lib in libs.items():
            out = torch.full_like(x, float("nan"))

            def launch():
                _build.hab_block(x, cab, w, nh, ids, out, c_real)

            with_library(lib, launch)
            ms = with_library(lib, lambda: time_ms(launch, 20))
            line.append(f"{name} {ms:.4f} ms ({rel_err(out, ref):.1e})")
        print(" | ".join(line), flush=True)
        del x, cab, w
        torch.cuda.empty_cache()


def time_k10_shape(gen: torch.Generator) -> None:
    """Kernel 9 as built at kernel 10's upscale shape against kernel 10 on
    the same keys pre-gathered (m 144: the OCAB's cross attention)."""
    c, nh, ws, ows = 96, 6, 8, 12
    q, k_map, v_map, bias = oca_inputs(gen, c, nh, ws, ows, K10_SIDE,
                                       K10_IMAGES)
    nwin = K10_SIDE // ws
    kw, vw = (extract_overlapping_windows(m, ws, ows, nwin, nwin)
              .contiguous() for m in (k_map, v_map))
    out9, out10 = torch.empty_like(q), torch.empty_like(q)
    grid = (K10_IMAGES, nwin, nwin)
    frag = fo.bias_fragments(bias, (c // nh) ** -0.5)
    ms9 = time_ms(lambda: _build.oca(q, k_map, v_map, frag, nh, ws, ows,
                                     grid, out9), 5)
    ms10 = time_ms(lambda: _build.window_attention_tc(
        q, kw, vw, frag, None, nh, (c // nh) ** -0.5, out10), 5)
    print(f"k10_shape q {list(q.shape)} m {ows * ows}: kernel 9 {ms9:.3f} ms"
          f" | kernel 10 {ms10:.3f} ms | max |9 - 10| / max |10| "
          f"{rel_err(out9, out10.float()):.1e}", flush=True)


def time_copy(libs: dict, gen: torch.Generator) -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tag, shape in dp.PROBE_SHAPES:
        x = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
        nbytes = x.numel() * x.element_size()
        band = nbytes // (shape[0] * shape[1] // dp.PROBE_RB)
        dst = torch.empty_like(x)
        line = [tag]
        for name, lib in libs.items():
            grid = COPY_GRIDS.get(name, lambda n, s: dp.copy_grid(n))
            blocks = grid(nbytes, sms)
            dst.zero_()

            def launch(_):
                _build.stream_copy(x, dst, blocks, band)

            with_library(lib, lambda: launch(x))
            ok = torch.equal(dst, x)
            ms = with_library(lib, lambda: dp.copy_ms(launch, x, 20))
            line.append(f"{name} {ms:.4f} ms{'' if ok else ' (WRONG)'}")
        ms = dp.copy_ms(dst.copy_, x, 20)
        line.append(f"copy_ {ms:.4f} ms")
        print(" | ".join(line), flush=True)
        del x, dst
        torch.cuda.empty_cache()


def main(names: list[str]) -> int:
    if not torch.cuda.is_available():
        print("attn_copy_variants: no CUDA device", file=sys.stderr)
        return 1
    names = names or [*VARIANTS, "k10_shape"]
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu="
                           "name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _, _, report = _build.build()
    for source, kernel in KERNEL.items():
        print("main", source,
              usage(report, kernel) or "(cached build: no ptxas report)")
    gen = torch.Generator().manual_seed(0)
    built_names = [n for n in names if n in VARIANTS]
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = {OCA: {"main": _build.library()},
                HAB: {"main": _build.library()},
                COPY: {"main": _build.library()}}
        if built_names:
            with ThreadPoolExecutor(len(built_names)) as pool:  # in parallel
                built = list(pool.map(lambda n: build(n, Path(tmp)),
                                      built_names))
            for name, (lib, use) in zip(built_names, built):
                if lib is not None:
                    source = VARIANTS[name][0]
                    libs[COMPILED.get(source, source)][name] = lib
                print(name, use, flush=True)
        with torch.inference_mode():
            if len(libs[OCA]) > 1:
                time_oca(libs[OCA], gen)
            if len(libs[HAB]) > 1 or "hab" in names:
                time_hab(libs[HAB], gen)
            if "k10_shape" in names:
                time_k10_shape(gen)
            if len(libs[COPY]) > 1 or "copy" in names:
                time_copy(libs[COPY], gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
