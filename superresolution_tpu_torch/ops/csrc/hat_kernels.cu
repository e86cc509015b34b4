// Hand-written CUDA kernels of the HAT stage of the hybrid RRDBNet -> HAT
// deploy path (sm_90a).
//
//   7 fused_cab_convs  (replaces superresolution_tpu/ops/pallas_hab.py:
//      fused_cab_convs / _cab_kernel): layernorm_kernel writes LN(x) in
//      bf16 (f32 statistics over C, divided by c_real: C, or the real
//      channels of a lane-padded map), then two launches of the shared
//      conv3x3_kernel of sr_kernels.cu: conv C->C/3 + bias + exact GELU
//      into a [B,H,W,C/3] workspace, conv C/3->C + bias. Each conv reads
//      its input through a zero halo, so conv1 sees 0 outside the image,
//      not LN(0) = ln bias, and conv2 sees 0, not GELU(bias): the trap the
//      Pallas kernel masks by hand (_cab_kernel's mask(ln, 0)).
//   8 fused_hab_block  (replaces ops/pallas_hab.py: fused_hab_block /
//      fused_hab_block_inference, _fused_fwd_impl / _kernel / _body):
//      hab_kernel<..., false>, one thread block per window. LN1 ->
//      qkv -> per head softmax(q k^T hd^-1/2 + rpb[h] (+ -1e9 where region
//      ids differ)) v -> proj -> x1 = x + proj + cab -> LN2 -> fc1 -> exact
//      GELU -> fc2 -> x1 + o, with every intermediate in shared memory.
//      The four GEMMs (qkv, proj, fc1, fc2) and the attention run on the
//      tensor cores (gemm_tc, attend_tc; see "The tensor-core body"
//      below). Templated on (C, heads, tokens n, MLP hidden), instantiated
//      for (96, 6, 64, 192), (96, 6, 256, 192), (120, 6, 256, 240) and the
//      lane-padded (128, 8, 64, 192): 8x8 and 16x16 windows, head dim 16
//      and 20. Both LNs divide by c_real.
//  11 strip_hab_block  (replaces ops/pallas_hab_strip.py: strip_hab_block,
//      _kernel): the same body, hab_kernel<..., true>, reading its window
//      straight from the spatial maps x, cab_y [B,H,W,C] and writing the
//      output map in place of the window layout. On the TPU the strips
//      keep a VMEM block large; here the natural unit is kernel 8's, one
//      block per (image, window), so the two kernels are one body with
//      two address maps. In a shifted block, token (tr, tc) of window
//      (wr, wc) is the pixel ((wr*ws + tr + shift) mod H, (wc*ws + tc +
//      shift) mod W): the roll, as index arithmetic, with no halo. The
//      Swin mask comes from region ids computed from the rolled-frame
//      position (wr*ws + tr, wc*ws + tc), whose regions on a side of L are
//      [0, L-ws), [L-ws, L-shift), [L-shift, L), as the TPU kernel computes
//      them from iotas. The CAB term is bf16(cab_y * se[b]) (se: sigmoid *
//      conv_scale, f32), rounded once, and the output goes back to the
//      pixel it came from. What it removes per HAB: two rolls, two
//      partitions, the merge, the roll back and the SE and conv_scale
//      passes around kernel 8.
//   (Kernel 12, fused_cab_convs_pair, is kernel 7's function: it runs
//      kernel 7's one-launch tensor-core body, cab_kernels.cu
//      cab_tc_kernel.)
//   (Kernel 9, the OCAB's gathered attention, is in oca_kernels.cu: it
//      shares kernel 10's FlashAttention-2 body, flash_tc.cuh, whose
//      online softmax kernels 8 and 11 take too.)
//
// Kernel 8's shared memory: at n 256 a whole window's five [n, C+8] bf16
// tiles would take 266 KB (C 96) or 328 KB (C 120), beyond the 227 KB a
// block may have. So the block first computes LN1 and k, v of all n
// tokens, 64 rows at a time, into [n, C+8] K and V tiles that stay for
// the block's life (132 KB at n 256, C 120); then for each tile of 64
// query rows it recomputes LN1, computes q, attends over all n keys with
// an online softmax in 32-key tiles, and runs proj, LN2 and the MLP on
// the tile. The
// recomputed LN1 costs 2% of the block's operations. Rows of C = 120
// (head dim 20) are not a multiple of 32 lanes: the LN and product loops
// mask the columns past C, and a head's columns are read as bf16 pairs
// (4-byte aligned at every head dim here). At the lane-padded C 128 the
// block takes 111 KB; its pad heads read zero q, k and v columns, so they
// attend uniformly over zero values and write exactly zero, and every pad
// lane of the output stays zero (zero weights, biases and LN parameters).
//
// The tensor-core body (kernels 8 and 11). The same layout of work and
// one pass over memory: each GEMM's A operand is the block's shared tile
// (LN1 out, the attention out, LN2 out, the GELU hidden; ldmatrix), its
// B operand the dense kernel packed once by the model in mma.sync's
// fragment order (ops/hab.mma_weights), one 8-byte load a lane and
// fragment through L1, which all the blocks share; mma.sync m16n8k16 with
// f32 sums, 8 warps as 2 x 32 rows by 4 column groups. The weights are
// not staged in shared memory: at (120, 6, 256, 240) the block's tiles
// take 219 KB of the 227 KB a block may have. The values are stored
// transposed ([C + 8][n + 8]), so P V's B fragments are 4-byte loads; the
// attention is flash_tc.cuh's online softmax over 32-key tiles with the
// rpb and the Swin mask added to the logits in f32 (attend_tc). Row
// strides of C + 8 (C + 16 at C 120) keep a fragment's 8 rows on
// distinct banks; at C 120 the K of the GEMMs pads to 128 with zero
// columns of the A tiles and zero rows of the packed weights. LN and GELU
// stay on the CUDA cores.
//
// Rounding follows the reference: f32 accumulation and f32 softmax; bf16
// stores of LN outputs, q, k, v, the probabilities, the attention output,
// proj, x1, the MLP hidden and o. The probabilities are rounded before
// the online softmax's final normalisation. The -1e9 mask underflows to
// exactly 0 (2^x of -1e9 log2 e).
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s; ridge ~295 FLOP/B):
// the HAB does C (3C + C + 2 MLP) + 2 n C MACs per token for 6 C bytes
// (x, cab, out) -- 86,016 MACs for 576 bytes at (96, 64, 192), 299
// FLOP/B, and more at n 256; kernel 11 the same; the CAB (kernels 7 and
// 12) 55,296 MACs per pixel for 384 bytes at C 96, 288 FLOP/B. All sit at
// or near the ridge, so a fast form needs both the tensor cores and one
// pass over memory: kernels 8 and 11 read each activation once and write
// each output once. Kernel 7's three-launch body here (LN, then two
// conv3x3_kernel launches) runs its products on the CUDA cores in f32 FMA
// (67 TFLOP/s peak) and writes LN(x) and its hidden map besides: it serves
// only the shapes its one-launch body does not take.
//
// Planted faults (`plant`, a bit mask; 0 in use) let a check show it sees
// what it holds: kernel 11 PLANT_CLAMP (x and cab_y read at coordinates
// clamped to the map instead of wrapped), PLANT_NO_SE (cab_y unscaled),
// PLANT_NO_MASK (no region mask); kernels 8 and 11 PLANT_SKIP_SLAB (the
// first k-step, 16 input channels, of the q, k and v GEMMs skipped),
// PLANT_NO_LN2 (fc1 fed x1 in place of LN2(x1)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace ce = conv_engine;

constexpr float kEps = 1e-5f;
constexpr int NT = 256;         // threads per block
constexpr int RT = 64;          // rows per tile of kernel 8

enum {
  PLANT_CLAMP = 1, PLANT_NO_SE = 2, PLANT_NO_MASK = 4,   // kernel 11
  PLANT_SKIP_SLAB = 8, PLANT_NO_LN2 = 16,                // kernels 8, 11
};

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rbf(float v) {  // round to bf16
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- LayerNorm rows: [rows, C] bf16 -> bf16, one warp per row ----------
constexpr int LN_THREADS = 256;

__global__ void __launch_bounds__(LN_THREADS)
    layernorm_kernel(const bf16* __restrict__ x, int rows, int C, int c_real,
                     const float* __restrict__ s,
                     const float* __restrict__ b, bf16* __restrict__ out) {
  const int row = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp
  const bf16* xr = x + (size_t)row * C;
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = f(xr[c]);
    sum += v;
    sq += v * v;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / c_real;
  const float rs = rsqrtf(sq / c_real - mu * mu + kEps);
  for (int c = lane; c < C; c += 32)
    out[(size_t)row * C + c] =
        __float2bfloat16((f(xr[c]) - mu) * rs * s[c] + b[c]);
}

// ---- pieces of kernel 8 (blockDim.x == NT) ----------------------------

// LN of `rows` rows of a [*, C] smem tile (row stride lda) into another,
// one warp per row, the statistics divided by c_real; columns past C
// masked.
template <int C>
__device__ void ln_rows(const bf16* in, bf16* out, int lda, int rows,
                        int c_real, const float* __restrict__ s,
                        const float* __restrict__ b) {
  constexpr int J = (C + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NT / 32) {
    float v[J];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < C ? f(in[r * lda + c]) : 0.f;
      sum += v[j];
      sq += v[j] * v[j];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / c_real;
    const float rs = rsqrtf(sq / c_real - mu * mu + kEps);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      if (c < C) out[r * lda + c] = __float2bfloat16((v[j] - mu) * rs * s[c] + b[c]);
    }
  }
}

// Copy rows pix[0..rows) (each C contiguous bf16 at src + pix * C) into a
// padded smem tile.
template <int C>
__device__ __forceinline__ void load_tile(bf16* dst, int lda, const bf16* src,
                                          const int* pix, int rows) {
  static_assert(C % 8 == 0, "16-byte rows");
  for (int e = threadIdx.x; e < rows * (C / 8); e += NT) {
    const int r = e / (C / 8), c8 = e % (C / 8);
    *reinterpret_cast<uint4*>(dst + r * lda + c8 * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)pix[r] * C + c8 * 8);
  }
}

// ---- the tensor-core pieces of kernels 8 and 11 ----------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// [RT, K] (smem, row stride lda; columns K .. 16 KS zero) @ W on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 sums). W is packed in fragment
// order (ops/hab.mma_weights): [KS k-steps][NFT 8-column fragments][32
// lanes] uint2, lane 4 g + t holding the B fragment {W[16 ks + 2 t + e][8 j
// + g], W[16 ks + 8 + 2 t + e][8 j + g]}, so each fragment is one 8-byte
// load through L1 (the weights are the same for every block). The output
// is fragments j0 .. j0 + NF - 1. 8 warps: 2 of 32 rows (A by ldmatrix
// from the tile) x 4 warp columns, warp column wn taking fragments j0 + wn
// + 4 i, at most 4 a pass. The k-steps start at `first` (0; 1 is a
// planted fault). epi(row, col, acc), col counted from 8 j0, sees every
// output once.
template <int KS, int NF, int NFT, typename Epi>
__device__ __forceinline__ void gemm_tc(const bf16* A, int lda,
                                        const uint2* __restrict__ W, int j0,
                                        int first, Epi epi) {
  constexpr int WN = 4, PER = (NF + WN - 1) / WN, NJ = PER < 4 ? PER : 4;
  static_assert(RT == 64 && NT == 256, "2 x 4 warps of 32 rows");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t a_base = ce::smem_u32(A + (wm * 32 + (lane & 15)) * lda +
                                       (lane >> 4) * 8);
  const uint32_t a_frag = 16 * lda * 2;  // bytes between the 2 M fragments
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += NJ) {
    float acc[2][NJ][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][jj][e] = 0.f;
#pragma unroll 2
    for (int ks = first; ks < KS; ++ks) {
      uint32_t af[2][4];
      ce::ldmatrix_x4(af[0], a_base + ks * 32);
      ce::ldmatrix_x4(af[1], a_base + a_frag + ks * 32);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = wn + WN * (i0 + jj);
        if (j < NF) {
          const uint2 bw = __ldg(W + ((size_t)ks * NFT + j0 + j) * 32 + lane);
          ce::mma_bf16(acc[0][jj], af[0], bw.x, bw.y);
          ce::mma_bf16(acc[1][jj], af[1], bw.x, bw.y);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = wn + WN * (i0 + jj);
      if (j >= NF) continue;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          epi(wm * 32 + f * 16 + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1),
              acc[f][jj][e]);
    }
  }
}

// Softmax attention of the tile's RT query rows (qs [RT][lda], rows t0 ..
// of the window) over NK keys (ks [NK][lda], the values transposed in vt
// [C + 8][ldv]), every head, on the tensor cores: warp w takes query tile
// w % 4 of heads w / 4, w / 4 + 2, ...; per head and query tile S = Q K^T
// by mma.sync (an m16n8k8 step over head dim 20's last 4 columns, the
// lanes past them loading zero), the logit in log2 units (S hd^-1/2 +
// rpb) log2 e, -1e9 log2 e where the region ids differ, then the online
// softmax and O += P V of flash_tc.cuh (P rounded to bf16), over tiles of
// 32 keys; every fragment a 4-byte load (head dim 20's heads start at
// 40-byte offsets, which ldmatrix does not take). O / row sum is stored
// in bf16 into outs [RT][lda]. no_mask: a planted fault.
template <int C, int NH, int NK>
__device__ __forceinline__ void attend_tc(const bf16* qs, const bf16* ks,
                                          const bf16* vt, int lda, int ldv,
                                          int t0, float scale_log2,
                                          const float* __restrict__ rpb,
                                          const int* ids, bool masked,
                                          bf16* outs) {
  constexpr int HD = C / NH, DT = (HD + 7) / 8, KT = 32, NTK = KT / 8;
  static_assert(NH % 2 == 0 && RT == 64 && NT == 256, "8 warps, 4 tiles");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16 + g;  // this lane's rows r0, r0 + 8
  for (int h = warp >> 2; h < NH; h += 2) {
    const bf16* qh = qs + h * HD + 2 * t;
    uint32_t qa[4], qb[2] = {0u, 0u};
    qa[0] = ld32(qh + r0 * lda);
    qa[1] = ld32(qh + (r0 + 8) * lda);
    qa[2] = ld32(qh + r0 * lda + 8);
    qa[3] = ld32(qh + (r0 + 8) * lda + 8);
    if (HD > 16 && t < (HD - 16) / 2) {
      qb[0] = ld32(qh + r0 * lda + 16);
      qb[1] = ld32(qh + (r0 + 8) * lda + 16);
    }
    const int id_r[2] = {masked ? ids[t0 + r0] : 0,
                         masked ? ids[t0 + r0 + 8] : 0};
    const float* brow = rpb + ((size_t)h * NK + t0 + r0) * NK + 2 * t;
    float o[DT][4], mx[2], sum[2];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    mx[0] = mx[1] = flash_tc::neg_inf();
    sum[0] = sum[1] = 0.f;
    for (int kt = 0; kt < NK; kt += KT) {
      float s[NTK][4];
#pragma unroll
      for (int n = 0; n < NTK; ++n) {
        const bf16* kr = ks + (kt + 8 * n + g) * lda + h * HD + 2 * t;
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        ce::mma_bf16(s[n], qa, ld32(kr), ld32(kr + 8));
        if (HD > 16)
          ce::mma_bf16_k8(s[n], qb[0], qb[1],
                          t < (HD - 16) / 2 ? ld32(kr + 16) : 0u);
      }
#pragma unroll
      for (int n = 0; n < NTK; ++n) {
        const int j = kt + 8 * n;  // + 2 t + (e & 1)
        const float2 b0 = __ldg(reinterpret_cast<const float2*>(brow + j));
        const float2 b1 =
            __ldg(reinterpret_cast<const float2*>(brow + 8 * NK + j));
        const float bb[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = (s[n][e] * scale_log2 + bb[e] * flash_tc::LOG2E);
          if (masked && id_r[e >> 1] != ids[j + 2 * t + (e & 1)])
            v += flash_tc::NEG_LOG2;
          s[n][e] = v;
        }
      }
      float tmax[2];
      flash_tc::tile_max<NTK>(s, tmax);
      flash_tc::online_softmax<NTK, DT>(s, tmax, mx, sum, o);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t pa[4];
        flash_tc::p_fragment<NTK>(s, kk, pa);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const bf16* vr = vt + (h * HD + 8 * d + g) * ldv + kt + 16 * kk +
                           2 * t;
          ce::mma_bf16(o[d], pa, ld32(vr), ld32(vr + 8));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / flash_tc::quad_sum(sum[r]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int col = 8 * d + 2 * t;
        if (col < HD)
          *reinterpret_cast<__nv_bfloat162*>(outs + (r0 + 8 * r) * lda +
                                             h * HD + col) =
              __floats2bfloat162_rn(o[d][2 * r] * inv,
                                    o[d][2 * r + 1] * inv);
      }
    }
  }
}

// ---- kernels 8 and 11: the HAB block body, one block per window --------
struct HabArgs {
  const bf16* x;            // kernel 8: [nb, n, C] windows; 11: [B,H,W,C]
  const bf16* cab;          // the same layout; kernel 8: conv_scale applied
  bf16* out;                // the same layout
  const float* ln1_s;       // [C]
  const float* ln1_b;
  const uint2* wqkv;        // [C, 3C], columns q | k | v, packed (below)
  const float* bqkv;        // [3C]
  const float* rpb;         // [heads, n, n]
  const uint2* wp;          // [C, C], packed
  const float* bp;
  const float* ln2_s;
  const float* ln2_b;
  const uint2* w1;          // [C, MLP], packed
  const float* b1;
  const uint2* w2;          // [MLP, C], packed: the dense kernels in
  const float* b2;          // mma.sync's fragment order (ops/hab.mma_weights)
  const int* ids;           // kernel 8: [nw_img, n] region ids, or null
  int nw_img;
  float scale;              // head_dim ** -0.5
  int c_real;               // the LNs' divisor: C, or the unpadded C
  // kernel 11
  const float* se;          // [B, C]: sigmoid(SE) * conv_scale
  int H, W, shift, plant;
};

// Row strides (bf16) of the [*, C] tiles: C + 8, or C + 16 where C + 8
// rows would put a fragment's 8 rows on one bank (C 120); of the
// transposed values: N + 8.
template <int C>
__host__ __device__ constexpr int hab_lda() {
  return (C + 8) % 64 == 0 ? C + 16 : C + 8;
}

// ks [N][LDA], the values transposed vt [C + 8][N + 8], xs, ys, qs
// [RT][LDA], hs [RT][MLP + 8], 3 N ints.
template <int C, int N, int MLP>
constexpr size_t hab_smem() {
  constexpr size_t lda = hab_lda<C>();
  return (N * lda + (size_t)(C + 8) * (N + 8) + 3 * RT * lda +
          RT * (MLP + 8)) * sizeof(bf16) +
         3 * N * sizeof(int);
}

__device__ __forceinline__ int region(int v, int len, int ws, int shift) {
  return (v >= len - ws) + (v >= len - shift);
}

template <int C, int NH, int N, int MLP, bool STRIP>
__global__ void __launch_bounds__(NT, 1) hab_kernel(const HabArgs a) {
  constexpr int LDA = hab_lda<C>();  // smem row stride of [*, C] tiles
  constexpr int LDH = MLP + 8;    // smem row stride of the MLP hidden tile
  constexpr int LDV = N + 8;      // row stride of the transposed values
  constexpr int WS = N == 64 ? 8 : 16;
  constexpr int KS_C = (C + 15) / 16, KS_M = MLP / 16;  // GEMM k-steps
  static_assert(N % RT == 0 && C % NH == 0 && WS * WS == N, "geometry");
  static_assert(C % 8 == 0 && MLP % 16 == 0 && 16 * KS_C <= LDA, "widths");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [N, LDA] keys of the window
  bf16* vs = ks + N * LDA;         // [C + 8, LDV] values, transposed
  bf16* xs = vs + (C + 8) * LDV;   // [RT, LDA] x of the tile, then x1
  bf16* ys = xs + RT * LDA;  // LN1(x), then attention out, then LN2(x1)
  bf16* qs = ys + RT * LDA;  // q
  bf16* hs = qs + RT * LDA;  // [RT, LDH] MLP hidden
  int* ids = reinterpret_cast<int*>(hs + RT * LDH);  // [N] region ids
  int* pix = ids + N;  // [N] token t's row of C values in out
  int* rd = pix;       // [N] ... in x and cab (pix + N under PLANT_CLAMP)
  const float* se = nullptr;
  bool masked;
  if (STRIP) {
    // window (b, wr, wc); token t at rolled-frame (wr*WS + t/WS,
    // wc*WS + t%WS), which is map pixel (that + shift) mod (H, W)
    const int nwc = a.W / WS, nw = (a.H / WS) * nwc;
    const int b = blockIdx.x / nw, w = blockIdx.x % nw;
    const int r0 = (w / nwc) * WS, c0 = (w % nwc) * WS;
    se = a.se + (size_t)b * C;
    masked = a.shift != 0 && !(a.plant & PLANT_NO_MASK);
    if (a.plant & PLANT_CLAMP) rd = pix + N;
    for (int t = threadIdx.x; t < N; t += NT) {
      const int rr = r0 + t / WS, cc = c0 + t % WS;
      const int r = rr + a.shift, c = cc + a.shift;
      pix[t] = (b * a.H + r - (r >= a.H ? a.H : 0)) * a.W + c -
               (c >= a.W ? a.W : 0);
      if (a.plant & PLANT_CLAMP)  // read the edge in place of the wrap
        rd[t] = (b * a.H + min(r, a.H - 1)) * a.W + min(c, a.W - 1);
      ids[t] = region(rr, a.H, WS, a.shift) * 3 +
               region(cc, a.W, WS, a.shift);
    }
  } else {
    masked = a.ids != nullptr;
    for (int t = threadIdx.x; t < N; t += NT) {
      pix[t] = blockIdx.x * N + t;
      if (masked) ids[t] = a.ids[(size_t)(blockIdx.x % a.nw_img) * N + t];
    }
  }
  // ys's columns past C (the k-steps' zero pad) and vt's pad rows (read
  // only into output columns that are dropped)
  for (int e = threadIdx.x; e < RT * (LDA - C); e += NT)
    ys[(e / (LDA - C)) * LDA + C + e % (LDA - C)] = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < 8 * LDV; e += NT)
    vs[C * LDV + e] = __float2bfloat16(0.f);
  const int skip = (a.plant & PLANT_SKIP_SLAB) ? 1 : 0;  // planted
  __syncthreads();
  // k and v of every token of the window
  for (int t0 = 0; t0 < N; t0 += RT) {
    load_tile<C>(xs, LDA, a.x, rd + t0, RT);
    __syncthreads();
    ln_rows<C>(xs, ys, LDA, RT, a.c_real, a.ln1_s, a.ln1_b);
    __syncthreads();
    gemm_tc<KS_C, C / 8, 3 * C / 8>(ys, LDA, a.wqkv, C / 8, skip,
                                    [&](int r, int c, float acc) {
      ks[(t0 + r) * LDA + c] = __float2bfloat16(acc + a.bqkv[C + c]);
    });
    gemm_tc<KS_C, C / 8, 3 * C / 8>(ys, LDA, a.wqkv, 2 * C / 8, skip,
                                    [&](int r, int c, float acc) {
      vs[c * LDV + t0 + r] = __float2bfloat16(acc + a.bqkv[2 * C + c]);
    });
    __syncthreads();
  }
  // each tile of RT query rows through attention, proj and the MLP
  for (int t0 = 0; t0 < N; t0 += RT) {
    load_tile<C>(xs, LDA, a.x, rd + t0, RT);
    __syncthreads();
    ln_rows<C>(xs, ys, LDA, RT, a.c_real, a.ln1_s, a.ln1_b);
    __syncthreads();
    auto q_epi = [&](int r, int c, float acc) {
      qs[r * LDA + c] = __float2bfloat16(acc + a.bqkv[c]);
    };
    auto proj_epi = [&](int r, int c, float acc) {
      const float t = rbf(f(xs[r * LDA + c]) + rbf(acc + a.bp[c]));
      float cv = f(a.cab[(size_t)rd[t0 + r] * C + c]);
      if (STRIP && !(a.plant & PLANT_NO_SE)) cv = rbf(cv * se[c]);
      xs[r * LDA + c] = __float2bfloat16(t + cv);
    };
    auto fc1_epi = [&](int r, int c, float acc) {
      hs[r * LDH + c] = __float2bfloat16(gelu_erf(acc + a.b1[c]));
    };
    auto fc2_epi = [&](int r, int c, float acc) {
      a.out[(size_t)pix[t0 + r] * C + c] =
          __float2bfloat16(f(xs[r * LDA + c]) + rbf(acc + a.b2[c]));
    };
    gemm_tc<KS_C, C / 8, 3 * C / 8>(ys, LDA, a.wqkv, 0, skip, q_epi);
    __syncthreads();
    attend_tc<C, NH, N>(qs, ks, vs, LDA, LDV, t0, a.scale * flash_tc::LOG2E,
                        a.rpb, ids, masked, ys);
    __syncthreads();
    gemm_tc<KS_C, C / 8, C / 8>(ys, LDA, a.wp, 0, 0, proj_epi);
    __syncthreads();
    if (a.plant & PLANT_NO_LN2)  // planted: fc1 reads x1, not LN2(x1)
      for (int e = threadIdx.x; e < RT * C; e += NT)
        ys[(e / C) * LDA + e % C] = xs[(e / C) * LDA + e % C];
    else
      ln_rows<C>(xs, ys, LDA, RT, a.c_real, a.ln2_s, a.ln2_b);
    __syncthreads();
    gemm_tc<KS_C, MLP / 8, MLP / 8>(ys, LDA, a.w1, 0, 0, fc1_epi);
    __syncthreads();
    gemm_tc<KS_M, C / 8, C / 8>(hs, LDH, a.w2, 0, 0, fc2_epi);
    __syncthreads();  // before the next tile overwrites xs and hs
  }
}

template <int C, int NH, int N, int MLP, bool STRIP>
int launch_hab(const HabArgs& a, int nb, cudaStream_t stream) {
  constexpr size_t bytes = hab_smem<C, N, MLP>();
  cudaError_t e = ce::allow_smem<hab_kernel<C, NH, N, MLP, STRIP>>(bytes);
  if (e != cudaSuccess) return (int)e;
  hab_kernel<C, NH, N, MLP, STRIP><<<nb, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The geometries of kernels 8 (STRIP false) and 11 (true); the lane-padded
// (128, 8, 64, 192) is kernel 8's only (kernel 11 takes no c_real, as the
// reference's strip path runs only unpadded).
template <bool STRIP>
int dispatch_hab(const HabArgs& a, int nb, int C, int nh, int n, int mlp,
                 cudaStream_t s) {
  if (C == 96 && nh == 6 && n == 64 && mlp == 192)
    return launch_hab<96, 6, 64, 192, STRIP>(a, nb, s);
  if (C == 96 && nh == 6 && n == 256 && mlp == 192)
    return launch_hab<96, 6, 256, 192, STRIP>(a, nb, s);
  if (C == 120 && nh == 6 && n == 256 && mlp == 240)
    return launch_hab<120, 6, 256, 240, STRIP>(a, nb, s);
  if (!STRIP && C == 128 && nh == 8 && n == 64 && mlp == 192)
    return launch_hab<128, 8, 64, 192, false>(a, nb, s);
  return (int)cudaErrorInvalidValue;
}

HabArgs hab_args(const void* x, const void* cab, void* out,
                 const void* const* w, float scale, int c_real) {
  HabArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.cab = static_cast<const bf16*>(cab);
  a.out = static_cast<bf16*>(out);
  a.ln1_s = static_cast<const float*>(w[0]);
  a.ln1_b = static_cast<const float*>(w[1]);
  a.wqkv = static_cast<const uint2*>(w[2]);
  a.bqkv = static_cast<const float*>(w[3]);
  a.rpb = static_cast<const float*>(w[4]);
  a.wp = static_cast<const uint2*>(w[5]);
  a.bp = static_cast<const float*>(w[6]);
  a.ln2_s = static_cast<const float*>(w[7]);
  a.ln2_b = static_cast<const float*>(w[8]);
  a.w1 = static_cast<const uint2*>(w[9]);
  a.b1 = static_cast<const float*>(w[10]);
  a.w2 = static_cast<const uint2*>(w[11]);
  a.b2 = static_cast<const float*>(w[12]);
  a.scale = scale;
  a.c_real = c_real;
  return a;
}

}  // namespace

extern "C" {

// All return the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a shape the kernels do not take.

int hat_layernorm(const void* x, int rows, int C, int c_real, const void* s,
                  const void* b, void* out, void* stream) {
  if (c_real < 1 || c_real > C) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + LN_THREADS / 32 - 1) /
                                     (LN_THREADS / 32));
  layernorm_kernel<<<blocks, LN_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), rows, C, c_real,
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

// Kernel 8. w: the 13 weights in the order of ops/_build.HAB_WEIGHTS, the
// dense ones packed in fragment order (ops/hab.mma_weights). plant: 0 but
// in the checks (PLANT_SKIP_SLAB, PLANT_NO_LN2).
int hat_hab_block(const void* x, const void* cab, void* out, int nb, int C,
                  int nh, int n, int mlp, const void* const* w,
                  const void* ids, int nw_img, float scale, int c_real,
                  int plant, void* stream) {
  if (nb < 1 || (ids && (nw_img <= 0 || nb % nw_img)) || c_real < 1 ||
      c_real > C)
    return (int)cudaErrorInvalidValue;
  HabArgs a = hab_args(x, cab, out, w, scale, c_real);
  a.ids = static_cast<const int*>(ids);
  a.nw_img = nw_img;
  a.plant = plant;
  return dispatch_hab<false>(a, nb, C, nh, n, mlp,
                             static_cast<cudaStream_t>(stream));
}

// Kernel 11 on the maps x, cab_y, out [B, H, W, C] and se [B, C] f32;
// window ws (n = ws * ws), shift 0 or ws / 2; w as hat_hab_block's.
int hat_strip_hab(const void* x, const void* cab, const void* se, void* out,
                  int B, int H, int W, int C, int nh, int ws, int shift,
                  int mlp, const void* const* w, float scale, int plant,
                  void* stream) {
  if (B < 1 || ws < 1 || H % ws || W % ws || (shift != 0 && shift != ws / 2))
    return (int)cudaErrorInvalidValue;
  HabArgs a = hab_args(x, cab, out, w, scale, C);
  a.se = static_cast<const float*>(se);
  a.H = H;
  a.W = W;
  a.shift = shift;
  a.plant = plant;
  return dispatch_hab<true>(a, B * (H / ws) * (W / ws), C, nh, ws * ws, mlp,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
