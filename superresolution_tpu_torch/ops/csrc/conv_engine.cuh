// The port's shared 3x3 conv engine (sm_90a): two bodies that take one
// policy struct, so B1, B2, kernels 4-6, 13's transposed convs, 15, 16
// and 18 share their arithmetic and differ only in how they load their
// input, read their weights and put their output (a policy's region may
// be a VALID conv's, as kernel 16's stages are: tc_run and load see the
// output's frame).
//
//   direct::conv_kernel<P, CO_T, DROP>  f32 FFMA on the CUDA cores, for
//       f32 tensors (kernels 15, 16, 18, and B1 and kernel 13's
//       transposed convs under precision "fp32") and the shapes the
//       tensor-core body does not take (kernel 4's conv_first; bf16
//       kernel 16 off B1's route rule).
//   tc::conv_tc_kernel<P, BN>  a bf16 implicit GEMM on the tensor cores
//       (mma.sync m16n8k16, bf16 in, f32 accumulation), for bf16 tensors
//       whose input pixels are 16-byte runs of C_in % 8 == 0 channels:
//       one block a tile, each running tile_body. The body's steps are
//       device functions of a tile index and the shared-memory base
//       (stage_input, tile_gemm, tile_epilogue), so a persistent kernel
//       can walk tiles and stages with them (kernel 6, dense_kernels.cu
//       rrdb_tc_kernel).
//
// Policy interface (all __device__ const members):
//   both bodies:  B; cin(); cout(); rows(), cols_out() (the output
//                 region); dropped(x, kx) (a planted fault: the tap kx of
//                 output column x reads zero).
//   direct body:  y0(), x0() (the region's origin in the input frame);
//                 load(b, y, x, ci) -> f32 (zero outside the frame);
//                 weight(tap, ci, o) -> f32; put(b, y, x, o, acc).
//   tc body:      wk, ldw (the K-major bf16 weights [9 * cin][ldw], row
//                 tap * cin + ci, ldw % 8 == 0, columns >= cout() zero);
//                 tc_run(b, y, x, c) -> the 8-channel run of logical
//                 channels c .. c + 7 (c % 8 == 0) of input pixel (y, x),
//                 16-byte aligned, or null (zero), so a pixel's channels
//                 may come from several sources and layouts; drops() (the
//                 dropped() fault is planted); skips(tx0) (every column
//                 of the tile at tx0 is stored as 0 whatever the sums: no
//                 products are formed); bias_at(o) (0 past cout()) and
//                 finish(b, y, x, o, v0, v1) -> float2, the values stored
//                 for the sums v0, v1 (bias added) of output channels o,
//                 o + 1 (o even) at output pixel (y, x) (activation,
//                 residuals read per pixel, masking; called for every
//                 pixel of the tile, also those past rows() or
//                 cols_out(), which are not stored); tc_put<BN>(tile,
//                 stride, b, ty0, tx0, n0, tid) stores the block's staged
//                 bf16 tile.
//
// The tensor-core body. GEMM rows (M) are the block's TH x TW output
// pixels, columns (N) BN output channels, depth (K) 9 taps x C_in. The
// block stages its input tile with a 1-pixel halo, all C_in channels,
// channels-last in shared memory once (cp.async, 16 bytes a copy), and
// streams the weights in slabs of one tap x KC channels through a ring
// of STAGES buffers, so the next slabs load while the tensor cores work.
// For tap (ky, kx) the A operand is the halo tile's window shifted by
// (ky, kx): ldmatrix takes one address per row, so the shift is only an
// address, and a masked row (the planted cross-pack fault) points at a
// zero row. Row strides are padded by 8 elements, which puts the 8 rows
// of an ldmatrix on distinct banks; B is read with ldmatrix.trans, and
// each k-step's fragments load while the previous k-step's products
// issue. Four warps, each 64 x BN/2, make a 128 x BN block of at most
// 128 columns; wider N is split evenly over ceil(N / 128) column blocks,
// adjacent in the grid, so a tile's second block finds its input in L2.
// Two or three blocks share an SM (Shape), so one block's staging and
// stores overlap another's products. The f32 sums plus the policy's
// bias_at go through its finish into a bf16 tile in shared memory (one
// rounding), which tc_put writes out, where its layout allows as bulk
// copies (the TMA unit) that keep the stores off the load/store path
// feeding the products, else in 16-byte or scalar stores.
//
// wgmma is not used: its shared-memory A operand needs the canonical
// core-matrix layout, which a shifted window breaks. What bounds each
// shape, and the times, are in the policies' sources.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_engine {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : 0.2f * v;
}

// ---- the direct body -------------------------------------------------
//
// One block: a TH x TW tile of the output region times CO_T output
// channels. Per chunk of CK input channels, the input tile with a
// 1-pixel halo (P::load gives zero where the op's frame has none) and
// the chunk's weights are staged in shared memory as f32; each thread
// accumulates PPT adjacent pixels times CO_T / NCG channels in
// registers and hands each sum to P::put.

namespace direct {

constexpr int TH = 8;     // output rows per block
constexpr int TW = 32;    // output columns per block
constexpr int CK = 8;     // input channels staged per chunk
constexpr int PPT = 4;    // adjacent output pixels per thread (along W)
constexpr int NCG = 4;    // channel groups per block
constexpr int NTHREADS = (TH * TW / PPT) * NCG;  // 256

// Tile index: blockIdx.x columns, blockIdx.y rows, blockIdx.z = b *
// n_co + output-channel group. DROP: consult P::dropped per tap (planted
// faults only; the launches in use take DROP = false).
template <class P, int CO_T, bool DROP>
__global__ void __launch_bounds__(NTHREADS, 2) conv_kernel(const P a) {
  constexpr int CPT = CO_T / NCG;
  constexpr int IH = TH + 2, IW = TW + 2;
  static_assert(CPT % 4 == 0, "CPT must be a multiple of 4");
  __shared__ float in_s[CK * IH * IW];
  __shared__ __align__(16) float w_s[9 * CK * CO_T];

  const int cin = a.cin(), cout = a.cout();
  const int n_co = (cout + CO_T - 1) / CO_T;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const int b = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * CO_T;
  const int fy = a.y0() + ty0, fx = a.x0() + tx0;  // the tile's frame origin

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pid = tid / NCG;
  const int ty = pid / (TW / PPT);
  const int tx = (pid % (TW / PPT)) * PPT;

  float acc[PPT][CPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[q][k] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    const int ck = min(CK, cin - c0);  // the chunk's channels (a last one
                                       // of a cin % CK != 0 is short)
    for (int e = tid; e < CK * IH * IW; e += NTHREADS) {
      const int ci = e % CK;
      const int pix = e / CK;
      const int px = pix % IW;
      const int py = pix / IW;
      const int c = c0 + ci;
      in_s[(ci * IH + py) * IW + px] =
          c < cin ? a.load(b, fy + py - 1, fx + px - 1, c) : 0.f;
    }
    for (int e = tid; e < 9 * CK * CO_T; e += NTHREADS) {
      const int co = e % CO_T;
      const int ci = (e / CO_T) % CK;
      const int tap = e / (CO_T * CK);
      const int c = c0 + ci;
      const int o = co0 + co;
      w_s[(tap * CK + ci) * CO_T + co] =
          (c < cin && o < cout) ? a.weight(tap, c, o) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < ck; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xv[PPT + 2];
#pragma unroll
        for (int q = 0; q < PPT + 2; ++q)
          xv[q] = in_s[(ci * IH + ty + ky) * IW + tx + q];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wr = &w_s[((ky * 3 + kx) * CK + ci) * CO_T + cg * CPT];
#pragma unroll
          for (int k = 0; k < CPT; k += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + k);
#pragma unroll
            for (int q = 0; q < PPT; ++q) {
              const float xi =
                  (DROP && a.dropped(fx + tx + q, kx)) ? 0.f : xv[q + kx];
              acc[q][k + 0] = fmaf(xi, wv.x, acc[q][k + 0]);
              acc[q][k + 1] = fmaf(xi, wv.y, acc[q][k + 1]);
              acc[q][k + 2] = fmaf(xi, wv.z, acc[q][k + 2]);
              acc[q][k + 3] = fmaf(xi, wv.w, acc[q][k + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (ty0 + ty >= a.rows()) return;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int o = co0 + cg * CPT + k;
    if (o >= cout) break;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      if (tx0 + tx + q >= a.cols_out()) break;
      a.put(b, fy + ty, fx + tx + q, o, acc[q][k]);
    }
  }
}

// CO_T: the output channels a block takes, 32 or 64; 0 picks by cout()
// (64 above 32). A policy whose load and weight reads are cheap may take
// 32 at any width: CO_T 64's 64 sums a thread spill at two blocks an SM.
template <class P, bool DROP, int CO_T = 0>
int launch(const P& a, cudaStream_t s) {
  static_assert(CO_T == 0 || CO_T == 32 || CO_T == 64, "CO_T");
  const int co_t = CO_T ? CO_T : a.cout() <= 32 ? 32 : 64;
  const long long nz = (long long)a.B * ((a.cout() + co_t - 1) / co_t);
  const int ny = (a.rows() + TH - 1) / TH;
  if (nz > 65535 || ny > 65535 || a.rows() < 1 || a.cols_out() < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.cols_out() + TW - 1) / TW, ny, (unsigned)nz);
  if constexpr (CO_T == 32)
    conv_kernel<P, 32, DROP><<<grid, NTHREADS, 0, s>>>(a);
  else if (co_t == 32)
    conv_kernel<P, 32, DROP><<<grid, NTHREADS, 0, s>>>(a);
  else
    conv_kernel<P, 64, DROP><<<grid, NTHREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace direct

// ---- PTX primitives ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// cp_async16 that reads src_bytes (16 or 0) and zero-fills the rest: with
// 0 it writes 16 zero bytes and reads nothing (src must still be a valid
// address)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst,
                                                 const void* src,
                                                 uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// an 8-byte cp.async (through L1: .cg takes only 16 bytes)
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums; not
// volatile, so the compiler may schedule it against the loads it waits on
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row) * b (8 x 8, col): the k8 shape, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// 2^x on the special-function unit (2^-22 relative; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Bulk copy (the TMA unit) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from shared to global memory, in this thread's bulk
// group; the async proxy reads shared memory, so generic stores to it
// must be fenced first.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Waits until this thread's bulk copies have read their shared source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- end PTX primitives -----------------------------------------------

// ---- the tensor-core body ---------------------------------------------

namespace tc {

constexpr int TH = 8;             // output rows per block
constexpr int TW = 16;            // output columns per block: one M fragment
constexpr int IH = TH + 2, IW = TW + 2;
constexpr int KC = 64;            // K rows a weight slab: one tap, 64 channels
constexpr int KSTEPS = KC / 16;   // mma k-steps per slab
constexpr int STAGES = 3;         // weight slabs in flight
constexpr int NTHREADS = 128;     // four warps
constexpr int MAX_CIN = 256;      // the staged input tile's channels
constexpr int ZERO_BYTES = 128;   // a zero row for masked A rows, then the tile

// The warp grid of a BN-column block: WARPS_M x WARPS_N = 2 x 2 warps,
// each MF tile rows (16-row M fragments) times NF 8-column fragments; at
// 32 columns (B1's convs 1-4) 4 x 1, so that a k-step's 8 products wait
// on 2 A and 2 B fragment loads, not 4 and 1. Up to 96 columns three
// blocks share an SM (at most 168 registers a thread), and their warps
// hide the B loads' latency; wider blocks fit two, and load each
// k-step's B fragments one k-step ahead as they do A's.
template <int BN, int ROWS = TH>
struct Shape {
  static constexpr int WARPS_N = BN == 32 ? 1 : 2;
  static constexpr int WARPS_M = NTHREADS / 32 / WARPS_N;
  static constexpr int MF = ROWS / WARPS_M;
  static constexpr int NF = BN / (8 * WARPS_N);
  static constexpr int MIN_BLOCKS = BN <= 96 ? 3 : 2;
  static constexpr bool B_AHEAD = MIN_BLOCKS == 2;
  static_assert(NF >= 1 && NF <= 8 && NF * 8 * WARPS_N == BN, "BN");
};

// ROWS: the tile's output rows (TH but in a persistent kernel's stage
// that takes shorter tiles to fit more blocks an SM).
template <int BN, int ROWS = TH>
constexpr size_t smem_bytes(int cin) {
  const size_t cp = (size_t)((cin + 15) & ~15);
  const size_t in_b = (size_t)(ROWS + 2) * IW * (cp + 8) * 2;
  const size_t w_b = (size_t)STAGES * KC * (BN + 8) * 2;
  const size_t out_b = (size_t)ROWS * TW * (BN + 8) * 2;
  return ZERO_BYTES + (in_b + w_b > out_b ? in_b + w_b : out_b);
}

// A tile of the output: image b, rows ty0.., columns tx0.., output
// channels n0.. (a BN-column block).
struct Tile {
  int b, ty0, tx0, n0;
};

// Tiles of a launch: B x tile rows x tile columns x BN-column blocks.
template <int BN, int ROWS = TH, class P>
__device__ __forceinline__ int tile_count(const P& a) {
  return a.B * ((a.rows() + ROWS - 1) / ROWS) *
         ((a.cols_out() + TW - 1) / TW) * ((a.cout() + BN - 1) / BN);
}

// Tile index t = ((b * tiles_y + tile row) * tiles_x + tile column) *
// column blocks + the BN-column block (conv_tc_kernel's blockIdx.x).
template <int BN, int ROWS = TH, class P>
__device__ __forceinline__ Tile tile_at(const P& a, int t) {
  const int tiles_x = (a.cols_out() + TW - 1) / TW;
  const int tiles_y = (a.rows() + ROWS - 1) / ROWS;
  const int nblk = (a.cout() + BN - 1) / BN;
  Tile tl;
  int u = t / nblk;
  tl.n0 = (t - u * nblk) * BN;
  tl.tx0 = (u % tiles_x) * TW;
  u /= tiles_x;
  tl.ty0 = (u % tiles_y) * ROWS;
  tl.b = u / tiles_y;
  return tl;
}

// The shared-memory map: a zero row for masked A rows, then the halo
// tile, then the weight ring; the bf16 output tile overlays the halo
// tile once the GEMM is done.
__device__ __forceinline__ bf16* halo_tile(unsigned char* smem) {
  return reinterpret_cast<bf16*>(smem + ZERO_BYTES);
}

__device__ __forceinline__ void zero_row(unsigned char* smem) {
  if (threadIdx.x < ZERO_BYTES / 16)
    reinterpret_cast<uint4*>(smem)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
}

// Issues the copies of the tile's input with its 1-pixel halo, all C_in
// channels, channels-last (cp.async, not committed: the caller's next
// commit takes them); runs tc_run gives null are written as zero.
template <int ROWS = TH, class P>
__device__ __forceinline__ void stage_input(const P& a, const Tile& tl,
                                            unsigned char* smem) {
  const int cin = a.cin();
  const int cp = (cin + 15) & ~15;
  const int pstr = cp + 8, cv = cp / 8;
  bf16* in_s = halo_tile(smem);
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < (ROWS + 2) * IW * cv; e += NTHREADS) {
    const int pix = e / cv, v = e - pix * cv;
    const int py = pix / IW, px = pix - py * IW;
    const bf16* src =
        v * 8 < cin ? a.tc_run(tl.b, tl.ty0 + py - 1, tl.tx0 + px - 1, v * 8)
                    : nullptr;
    bf16* dst = in_s + pix * pstr + v * 8;
    if (src != nullptr)
      cp_async16(smem_u32(dst), src);
    else
      *reinterpret_cast<uint4*>(dst) = zero4;
  }
}

// The GEMM of one tile into acc: streams the weight slabs through the
// ring (the first commit also takes any staged input not yet committed)
// and ends with every copy landed and the block synchronized, so the
// halo tile and the ring may be overwritten.
template <class P, int BN, int ROWS = TH>
__device__ __forceinline__ void tile_gemm(
    const P& a, const Tile& tl, bool live, unsigned char* smem,
    float (&acc)[Shape<BN, ROWS>::MF][Shape<BN, ROWS>::NF][4]) {
  using S = Shape<BN, ROWS>;
  constexpr int BSTR = BN + 8;      // weight and output tile row stride
  constexpr int VPR = BN / 8;       // 16-byte vectors per weight row
  const int cin = a.cin();
  const int cp = (cin + 15) & ~15;  // channels staged, zero past cin
  const int pstr = cp + 8;          // input tile pixel stride
  bf16* in_s = halo_tile(smem);
  bf16* w_s = in_s + (ROWS + 2) * IW * pstr;
  const int n0 = tl.n0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::WARPS_N, wn = warp % S::WARPS_N;
  static_assert(S::MF * S::WARPS_M == ROWS, "one M fragment a tile row");
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  const int nchunk = (cin + KC - 1) / KC;  // KC-channel chunks per tap
  const int nslab = live ? 9 * nchunk : 0;

  auto load_slab = [&](int s) {
    const int tap = s / nchunk, c0 = (s - tap * nchunk) * KC;
    bf16* buf = w_s + (s % STAGES) * KC * BSTR;
    for (int e = tid; e < KC * VPR; e += NTHREADS) {
      const int k = e / VPR, v = e - k * VPR;
      const int c = c0 + k, n = n0 + v * 8;
      bf16* dst = buf + k * BSTR + v * 8;
      if (c < cin && n < a.ldw)
        cp_async16(smem_u32(dst), a.wk + (size_t)(tap * cin + c) * a.ldw + n);
      else
        *reinterpret_cast<uint4*>(dst) = zero4;
    }
  };
  if (nslab > 0) load_slab(0);
  cp_async_commit();  // group 0: slab 0 (and the input tile, if staged)
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < nslab) load_slab(s);
    cp_async_commit();
  }

#pragma unroll
  for (int f = 0; f < S::MF; ++f)
#pragma unroll
    for (int j = 0; j < S::NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.f;

  // ldmatrix addresses: A row = tile column lane & 15 of the warp's first
  // tile row, channel offset (lane >> 4) * 8; B row = k lane & 15, column
  // the warp's first plus (lane >> 4) * 8
  const int a_col = lane & 15;
  const bool a_drop = a.drops() && a.dropped(tl.tx0 + a_col, 0);
  const uint32_t zero_u = smem_u32(smem);
  const uint32_t a_base = smem_u32(
      in_s + (wm * S::MF * IW + a_col) * pstr + (lane >> 4) * 8);
  const uint32_t b_base = smem_u32(
      w_s + (lane & 15) * BSTR + wn * S::NF * 8 + (lane >> 4) * 8);
  const uint32_t a_frag = IW * pstr * 2;  // bytes between tile rows

  // fragments of k-step kk of the current slab: A for the warp's MF tile
  // rows, B for its NF 8-column groups
  uint32_t af[2][S::MF][4], bf[S::B_AHEAD ? 2 : 1][S::NF][2];
  auto load_a = [&](uint32_t a_k, bool masked, uint32_t (&a4)[S::MF][4]) {
#pragma unroll
    for (int f = 0; f < S::MF; ++f)
      ldmatrix_x4(a4[f], masked ? zero_u : a_k + f * a_frag);
  };
  auto load_b = [&](uint32_t b_k, uint32_t (&b2)[S::NF][2]) {
#pragma unroll
    for (int j = 0; j + 1 < S::NF; j += 2) {
      uint32_t q[4];
      ldmatrix_x4_trans(q, b_k + j * 16);
      b2[j][0] = q[0], b2[j][1] = q[1];
      b2[j + 1][0] = q[2], b2[j + 1][1] = q[3];
    }
    if constexpr (S::NF % 2 == 1)
      ldmatrix_x2_trans(b2[S::NF - 1], b_k + (S::NF - 1) * 16);
  };

  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nslab) load_slab(s + STAGES - 1);
    cp_async_commit();
    const int tap = s / nchunk, c0 = (s - tap * nchunk) * KC;
    const int ky = tap / 3, kx = tap - ky * 3;
    const int nk = min(KSTEPS, (cp - c0) / 16);  // k-steps with channels
    const bool masked = a_drop && kx == 0;
    const uint32_t a_tap = a_base + ((ky * IW + kx) * pstr + c0) * 2;
    const uint32_t b_slab = b_base + (s % STAGES) * KC * BSTR * 2;
    constexpr uint32_t B_K = 16 * BSTR * 2;  // bytes between k-steps
    // the next k-step's fragments load while this one's products issue
    load_a(a_tap, masked, af[0]);
    if constexpr (S::B_AHEAD) load_b(b_slab, bf[0]);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk >= nk) break;
      if (kk + 1 < nk) {
        load_a(a_tap + (kk + 1) * 32, masked, af[(kk + 1) & 1]);
        if constexpr (S::B_AHEAD)
          load_b(b_slab + (kk + 1) * B_K, bf[(kk + 1) & 1]);
      }
      if constexpr (!S::B_AHEAD) load_b(b_slab + kk * B_K, bf[0]);
      const int bi = S::B_AHEAD ? (kk & 1) : 0;
#pragma unroll
      for (int f = 0; f < S::MF; ++f)
#pragma unroll
        for (int j = 0; j < S::NF; ++j)
          mma_bf16(acc[f][j], af[kk & 1][f], bf[bi][j][0], bf[bi][j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The f32 sums plus bias_at through the policy's finish into the bf16
// tile out_s (one rounding), then tc_put; returns once this thread's bulk
// copies have read out_s (the caller synchronizes the block before out_s
// is written again).
template <class P, int BN, int ROWS = TH>
__device__ __forceinline__ void tile_epilogue(
    const P& a, const Tile& tl, bf16* out_s,
    const float (&acc)[Shape<BN, ROWS>::MF][Shape<BN, ROWS>::NF][4]) {
  using S = Shape<BN, ROWS>;
  constexpr int BSTR = BN + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::WARPS_N, wn = warp % S::WARPS_N;
  const int b = tl.b, ty0 = tl.ty0, tx0 = tl.tx0, n0 = tl.n0;
  // accumulator (f, j, q): tile row wm * MF + f, column (lane >> 2) + 8 *
  // (q >> 1); GEMM column wn * NF * 8 + j * 8 + 2 * (lane & 3) + (q & 1)
#pragma unroll
  for (int j = 0; j < S::NF; ++j) {
    const int n = wn * S::NF * 8 + j * 8 + 2 * (lane & 3);
    const float b0 = a.bias_at(n0 + n), b1 = a.bias_at(n0 + n + 1);
#pragma unroll
    for (int f = 0; f < S::MF; ++f) {
      const int ty = wm * S::MF + f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tx = (lane >> 2) + 8 * h;
        bf16* row = out_s + (ty * TW + tx) * BSTR;
        const float2 v =
            a.finish(b, ty0 + ty, tx0 + tx, n0 + n, acc[f][j][2 * h] + b0,
                     acc[f][j][2 * h + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(row + n) =
            __floats2bfloat162_rn(v.x, v.y);
      }
    }
  }
  fence_async_smem();
  __syncthreads();
  if constexpr (ROWS == TH)
    a.template tc_put<BN>(out_s, BSTR, b, ty0, tx0, n0, tid);
  else  // the policy stores ROWS-row tiles (DenseConv)
    a.template tc_put<BN, ROWS>(out_s, BSTR, b, ty0, tx0, n0, tid);
  bulk_wait_read();
}

// One whole tile: stage, GEMM, epilogue with the output tile over the
// halo tile. Every thread of the block calls it for the same tile.
template <class P, int BN, int ROWS = TH>
__device__ __forceinline__ void tile_body(const P& a, int t,
                                          unsigned char* smem) {
  const Tile tl = tile_at<BN, ROWS>(a, t);
  const bool live = !a.skips(tl.tx0);
  zero_row(smem);
  if (live) stage_input<ROWS>(a, tl, smem);
  float acc[Shape<BN, ROWS>::MF][Shape<BN, ROWS>::NF][4];
  tile_gemm<P, BN, ROWS>(a, tl, live, smem, acc);
  tile_epilogue<P, BN, ROWS>(a, tl, halo_tile(smem), acc);
}

// One block a tile (grid: tile_count blocks).
template <class P, int BN>
__global__ void __launch_bounds__(NTHREADS, Shape<BN>::MIN_BLOCKS)
    conv_tc_kernel(const P a) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile_body<P, BN>(a, blockIdx.x, smem);
}

template <class P, int BN>
int launch_bn(const P& a, cudaStream_t s) {
  const size_t bytes = smem_bytes<BN>(a.cin());
  cudaError_t err = cudaFuncSetAttribute(
      conv_tc_kernel<P, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.B * ((a.rows() + TH - 1) / TH) *
                           ((a.cols_out() + TW - 1) / TW) *
                           ((a.cout() + BN - 1) / BN);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  conv_tc_kernel<P, BN><<<(unsigned)blocks, NTHREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// The body's own checks (the wrappers route only what passes them):
// bf16 weights with 8 <= cin <= MAX_CIN, cin % 8 == 0, ldw % 8 == 0.
template <class P>
int launch(const P& a, cudaStream_t s) {
  const int n = a.cout();
  if (a.cin() < 8 || a.cin() % 8 || a.cin() > MAX_CIN || a.ldw % 8 ||
      a.ldw < n || n < 1 || a.rows() < 1 || a.cols_out() < 1)
    return (int)cudaErrorInvalidValue;
  const int nblk = (n + 127) / 128;
  switch (((n + nblk - 1) / nblk + 15) / 16) {  // 16-column groups a block
    case 1: return launch_bn<P, 16>(a, s);
    case 2: return launch_bn<P, 32>(a, s);
    case 3: return launch_bn<P, 48>(a, s);
    case 4: return launch_bn<P, 64>(a, s);
    case 5: return launch_bn<P, 80>(a, s);
    case 6: return launch_bn<P, 96>(a, s);
    case 7: return launch_bn<P, 112>(a, s);
    default: return launch_bn<P, 128>(a, s);
  }
}

}  // namespace tc

// ---- launch set-up kept for the process --------------------------------
//
// A launcher that would read the SM count, raise a kernel's dynamic
// shared-memory limit or ask its occupancy on every call reads or makes
// each once a device instead: on small maps those calls cost about as
// much as the kernel.

constexpr int MAX_DEVICES = 64;

// *sms = the current device's SM count.
inline cudaError_t sm_count(int* sms) {
  static int known[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES)
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!known[dev]) {
    e = cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *sms = known[dev];
  return cudaSuccess;
}

// Lets Kernel take `bytes` of dynamic shared memory on the current device
// (raised once for the largest size asked so far) and, where per_sm is
// given, sets *per_sm to how many blocks of `threads` threads with `bytes`
// fit an SM (asked again only when the block differs from the last one).
template <auto Kernel>
cudaError_t allow_smem(size_t bytes, int threads = 0, int* per_sm = nullptr) {
  static size_t allowed[MAX_DEVICES];
  static size_t asked[MAX_DEVICES];
  static int asked_threads[MAX_DEVICES], fit[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool keep = dev < MAX_DEVICES;
  if (!keep || bytes > allowed[dev]) {
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    if (keep) allowed[dev] = bytes;
  }
  if (!per_sm) return cudaSuccess;
  if (keep && fit[dev] && asked[dev] == bytes && asked_threads[dev] == threads) {
    *per_sm = fit[dev];
    return cudaSuccess;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, Kernel, threads,
                                                    bytes);
  if (e == cudaSuccess && keep)
    asked[dev] = bytes, asked_threads[dev] = threads, fit[dev] = *per_sm;
  return e;
}

}  // namespace conv_engine
