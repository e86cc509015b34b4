// Kernel 9, the OCAB's overlapping cross-attention with its key/value
// gather, as FlashAttention-2 on the tensor cores (sm_90a).
//
//  9 flash_oca_gathered  (replaces superresolution_tpu/ops/
//    pallas_flash_oca.py: flash_oca_gathered, _fwd_impl, _kernel). For
//    each ws x ws query window (wr, wc) of image img and each head h,
//    with head dim hd = C / nh and scale = hd^-1/2:
//
//      out_h = softmax(q_h k_h^T * scale + bias[h]) v_h
//
//    q [B * nh_w * nw_w, ws * ws, C]; the zero-padded key and value maps
//    [B, hp, wp, C] (hp = nh_w * ws + ows - ws); key j of the window is
//    the map pixel (wr * ws + j / ows, wc * ws + j % ows); bias [nh, ws^2,
//    ows^2] f32; all bf16 but the bias. The padded keys are zero vectors
//    whose logits are the bias alone: they take part in the softmax, as
//    in the reference. Logits and softmax in f32; each probability is
//    rounded to bf16 before its product with v (the reference rounds its
//    probabilities to the input type), here before the final division
//    by the row sum, which the online form applies last.
//
// Geometries (C, nh, ws, ows), template instances: (96, 6, 8, 12), (96,
// 6, 8, 10), (96, 6, 16, 24), (120, 6, 16, 24) and the lane-padded (128,
// 8, 8, 12), whose two pad heads read zero q, k and v and write zeros.
//
// Bound on the H100: 2 ows^2 C MACs a query token (14.5 GFLOP at 256
// windows of 16 x 16, ows 24, C 96) against q, out and one read of the
// maps: ~0.017 ms at 989 TFLOP/s, bound by bytes at 3.35 TB/s. The
// exponentials set a second floor: one a logit, nh ws^2 ows^2 a window
// (226.5 M at that shape, ~0.06 ms on the SMs' special-function units),
// and every logit also takes its f32 bias, 4 bytes from L2.
//
// Design (FlashAttention-2 on mma.sync):
// - One block a window's NQ = 64 queries, all heads: one block a window
//   at ws 8, four at ws 16 (adjacent in the grid, so the three after the
//   first find the patch in L2). A warp takes PPW (head, 16-query tile)
//   pairs (3 at C 96: 8 warps; 2 at C 128: 16; 1 at C 120: 24; see
//   PPW_CAP), one query tile at heads a fixed stride apart, and holds
//   each one's output accumulators, row max and row sum in registers for
//   the block's life; q is staged in shared memory with the first key
//   tile.
// - The ows^2 keys stream through a ring of NSTAGE shared-memory stages
//   in tiles of KT keys (5 a ws 8 patch of 144 keys, the last half
//   padding; 18 at ws 16). A tile stages whole key pixels, all heads, k
//   and v, with 16-byte cp.async straight from the maps (8-byte at head
//   dim 20, whose heads start at 40-byte offsets), into rows of NH * HDP
//   + 8 elements:
//   each head padded to HDP = 16 or 24 columns (the pad columns zero),
//   so every ldmatrix row starts 16-byte aligned and the 8 rows of an
//   ldmatrix fall on distinct banks. Keys past ows^2 are zero rows whose
//   logits are -inf.
// - S = Q K^T: mma.sync m16n8k16 (and an m16n8k8 over the pad at head
//   dim 20), bf16 in, f32 sums; K's B fragments by ldmatrix. The
//   accumulators start from the bias / scale re-laid into the
//   accumulator's layout (by a model once, ops/flash_oca.bias_fragments;
//   here one 16-byte load a lane and 8-key tile, straight into the
//   accumulator registers), so the logit in log2 units is one multiply,
//   acc * scale log2 e. Then the tile's row max over the quad
//   of lanes that hold a row, the rescale of the running sum and output
//   by 2^(m_old - m_new), and p = 2^(s - m) on the special-function
//   unit. The sum of p is kept per lane in f32 and added over the quad
//   at the end.
// - O += P V: P's accumulators, rounded to bf16 pairs, are the A
//   fragments in registers; V's B fragments come by ldmatrix.trans.
// - The end: O / row sum, staged as bf16 in shared memory and written
//   as 16-byte stores: a block's 64 query rows are one contiguous run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_engine.cuh"

namespace {

namespace ce = conv_engine;
using ce::bf16;

// Faults the checks in chip_smoke.py plant (0 in every other launch).
constexpr int PLANT_PAD_MASKED = 1;   // the padded keys masked out of the
                                      // softmax (logit -inf)
constexpr int PLANT_NO_RESCALE = 2;   // the output not rescaled when a key
                                      // tile raises the row max
constexpr int PLANT_ROW_STRIDE = 4;   // map rows addressed at a stride of
                                      // wp - 1 pixels

constexpr int NQ_MAX = 64;   // queries a block
constexpr int KT = 32;       // keys a tile
constexpr int NSTAGE = 3;    // tiles in the ring: NSTAGE - 1 in flight
// (head, query tile) pairs a warp, at most: 3 at head dim 16 (8 warps, two
// blocks an SM in 128 registers), 1 at head dim 20 (whose 24 staged
// columns need more: 24 warps, one block an SM)
constexpr int PPW_CAP = 3;
constexpr int PPW_CAP_HD20 = 1;
constexpr int BLOCKS_CAP = 2;  // blocks an SM the registers are sized for
constexpr float LOG2E = 1.4426950408889634f;

struct OcaArgs {
  const bf16* q;       // [nb, ws^2, C]
  const bf16* k;       // maps [B, hp, wp, C]
  const bf16* v;
  const float4* bias;  // [nh, ws^2, ows^2] in fragment order (see below)
  bf16* out;           // [nb, ws^2, C]
  int nh_w, nw_w, hp, wp;
  float scale_log2;    // hd^-1/2 log2 e
  int plant;
};

// PLANTS: the instance that takes the planted faults (only the checks
// launch it, at one geometry); the others carry no code for them.
template <int C, int NH, int WS, int OWS, bool PLANTS>
struct Geo {
  static constexpr int HD = C / NH;
  static constexpr int HDP = (HD + 7) / 8 * 8;  // 16, or 24 at head dim 20
  static constexpr int N = WS * WS;
  static constexpr int M = OWS * OWS;
  static constexpr int NQ = N < NQ_MAX ? N : NQ_MAX;
  static constexpr int SPLIT = N / NQ;          // blocks a window
  static constexpr int QT = NQ / 16;            // query tiles a block
  static constexpr int PAIRS = NH * QT;
  // pairs a warp: the largest divisor of PAIRS up to the cap
  static constexpr int CAP = HD == 16 ? PPW_CAP : PPW_CAP_HD20;
  static constexpr int PPW = PAIRS % CAP == 0          ? CAP
                             : PAIRS % (CAP - 1) == 0 ? CAP - 1
                                                      : 1;
  static constexpr int WARPS = PAIRS / PPW;
  static constexpr int THREADS = 32 * WARPS;
  // at least 128 registers a thread
  static constexpr int MIN_BLOCKS =
      PLANTS || 512 / THREADS < 1 ? 1
      : 512 / THREADS < BLOCKS_CAP ? 512 / THREADS : BLOCKS_CAP;
  static constexpr int MT = (M + 7) / 8;        // 8-key tiles of the bias
  static constexpr int RS = NH * HDP + 8;       // staged key row, elements
  static constexpr int TILES = (M + KT - 1) / KT;
  static constexpr int DT = HDP / 8;            // 8-column tiles of a head
  // output tile row stride: 16-byte rows; the 8 rows of a fragment store
  // on distinct banks
  static constexpr int OS = (C + 8) % 64 == 0 ? C + 16 : C + 8;
  static constexpr size_t STAGE = (size_t)2 * KT * RS * 2;  // k and v
  static constexpr size_t QBYTES = (size_t)NQ * RS * 2;     // q, as k
  static constexpr size_t SMEM = QBYTES + (NSTAGE * STAGE > (size_t)NQ * OS * 2
                                               ? NSTAGE * STAGE
                                               : (size_t)NQ * OS * 2);
  static_assert(C % NH == 0 && (HD == 16 || HD == 20), "head dim");
  // warp w takes query tile w % QT of heads w / QT + pp HSTEP, pp < PPW:
  // its pairs' offsets differ by compile-time strides
  static constexpr int HSTEP = WARPS / QT;
  static_assert(N % NQ == 0 && NQ % 16 == 0 && PPW * WARPS == PAIRS &&
                    WARPS % QT == 0 && PPW * HSTEP == NH && THREADS <= 1024,
                "query tiles");
  static_assert(KT % 16 == 0 && M % 2 == 0, "key tiles");
  static_assert(OWS > WS && (OWS - WS) % 2 == 0, "overlap");
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int C, int NH, int WS, int OWS, bool PLANTS>
__global__ void __launch_bounds__(Geo<C, NH, WS, OWS, PLANTS>::THREADS,
                                  Geo<C, NH, WS, OWS, PLANTS>::MIN_BLOCKS)
    oca_kernel(const OcaArgs a) {
  using G = Geo<C, NH, WS, OWS, PLANTS>;
  constexpr int HD = G::HD, HDP = G::HDP, N = G::N, M = G::M, RS = G::RS;
  constexpr int PPW = G::PPW, DT = G::DT, NT = KT / 8;
  constexpr int THREADS = G::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // fragment row, column pair

  const long long b = blockIdx.x / G::SPLIT;         // the window
  const int q0 = (int)(blockIdx.x % G::SPLIT) * G::NQ;  // its first query
  const int per_img = a.nh_w * a.nw_w;
  const int img = (int)(b / per_img), wi = (int)(b % per_img);
  const int wr = wi / a.nw_w, wc = wi % a.nw_w;
  const int rs = PLANTS && (a.plant & PLANT_ROW_STRIDE) ? a.wp - 1 : a.wp;
  const long long corner = ((long long)img * a.hp + wr * WS) * rs + wc * WS;
  const bf16* kmap = a.k + corner * C;
  const bf16* vmap = a.v + corner * C;

  // element c of a pixel in a staged row: head c / HD, column c % HD
  constexpr int GW = HD == 16 ? 8 : 4;  // elements a copy
  constexpr int GR = C / GW;            // copies a pixel
  auto put = [](int col) {
    return HD == 16 ? col : col / HD * HDP + col % HD;
  };
  auto copy = [](bf16* dst, const bf16* src) {
    if (HD == 16)
      ce::cp_async16(ce::smem_u32(dst), src);
    else
      ce::cp_async8(ce::smem_u32(dst), src);
  };
  // k and v of tile t into stage st: key row jj holds key t KT + jj
  auto stage = [&](int t, int st) {
    bf16* ks = ring + (size_t)st * 2 * KT * RS;
    bf16* vs = ks + KT * RS;
    for (int e = tid; e < KT * GR; e += THREADS) {
      const int jj = e / GR, col = (e - jj * GR) * GW;
      const int j = t * KT + jj;
      const int dst = jj * RS + put(col);
      if (j < M) {
        const long long src =
            ((long long)(j / OWS) * rs + j % OWS) * C + col;
        copy(ks + dst, kmap + src);
        copy(vs + dst, vmap + src);
      } else if (HD == 16) {
        *reinterpret_cast<uint4*>(ks + dst) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vs + dst) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        *reinterpret_cast<uint2*>(ks + dst) = make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(vs + dst) = make_uint2(0u, 0u);
      }
    }
  };

  // the block's queries [NQ][RS] (group 0, with tile 0), then the ring
  bf16* qs = ring;
  ring += G::NQ * RS;
  if (HDP != HD)  // the pad columns of every head of q, k and v rows
    for (int e = tid; e < (G::NQ + NSTAGE * 2 * KT) * NH; e += THREADS)
      *reinterpret_cast<uint2*>(qs + (size_t)(e / NH) * RS +
                                (e % NH) * HDP + HD) = make_uint2(0u, 0u);
  const bf16* qg = a.q + ((size_t)b * N + q0) * C;
  for (int e = tid; e < G::NQ * GR; e += THREADS) {
    const int r = e / GR, col = (e - r * GR) * GW;
    copy(qs + r * RS + put(col), qg + r * C + col);
  }
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < G::TILES) stage(s, s);
    ce::cp_async_commit();
  }

  // pair pp of this warp: head h0 + pp HSTEP, query rows qr + g (+ 8) of
  // the block
  const int h0 = warp / G::QT, qr = (warp % G::QT) * 16;
  float o[PPW][DT][4], mx[PPW][2], sum[PPW][2];
#pragma unroll
  for (int pp = 0; pp < PPW; ++pp) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[pp][d][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[pp][r] = neg_inf();
      sum[pp][r] = 0.f;
    }
  }
  // a padded key (outside the image) for the planted mask
  const int pad = (OWS - WS) / 2;
  auto padded = [&](int j) {
    const int y = wr * WS + j / OWS, x = wc * WS + j % OWS;
    return y < pad || y >= a.hp - pad || x < pad || x >= a.wp - pad;
  };
  // ldmatrix rows of this lane: K (non-trans) key (lane & 7) + 8 (lane
  // >> 4), column 8 ((lane >> 3) & 1); Q, V (trans) and the x2 forms row
  // (lane & 7) + 8 ((lane >> 3) & 1), column 8 (lane >> 4)
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) << 3;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) << 3;

  for (int t = 0; t < G::TILES; ++t) {
    ce::cp_async_wait<NSTAGE - 2>();  // tile t has landed
    __syncthreads();                  // ... for every thread; the stage of
                                      // tile t - 1 is free
    if (t + NSTAGE - 1 < G::TILES)
      stage(t + NSTAGE - 1, (t + NSTAGE - 1) % NSTAGE);
    ce::cp_async_commit();
    const bf16* ks = ring + (size_t)(t % NSTAGE) * 2 * KT * RS;
    const uint32_t k_addr = ce::smem_u32(ks);
    const uint32_t v_addr = k_addr + KT * RS * 2;

#pragma unroll
    for (int pp = 0; pp < PPW; ++pp) {
      const int h = h0 + pp * G::HSTEP, row = q0 + qr + g;
      // q's A fragments: rows qr + {g, g + 8}, columns 2 tig (+ 1) (+ 8)
      // (+ 16 at head dim 20)
      const bf16* q_row = qs + (qr + v_row) * RS + h * HDP;
      uint32_t qa[4], qb[2];
      ce::ldmatrix_x4(qa, ce::smem_u32(q_row + v_col));
      if (HDP > 16) ce::ldmatrix_x2(qb, ce::smem_u32(q_row + 16));
      // the accumulators start from the bias / scale: accumulator (n, e) is
      // row + 8 (e >> 1), key t KT + 8 n + 2 tig + (e & 1), all four in
      // one float4 of the fragment-order bias (head, query tile, 8-key
      // tile, lane)
      const float4* bfrag =
          a.bias + (((size_t)h * (N / 16) + row / 16) * G::MT + t * (KT / 8)) *
                       32 + lane;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 bb = t * KT + n * 8 + 2 * tig < M
                              ? __ldg(bfrag + n * 32)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        s[n][0] = bb.x;
        s[n][1] = bb.y;
        s[n][2] = bb.z;
        s[n][3] = bb.w;
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t kf[4];
        ce::ldmatrix_x4(kf, k_addr + ((kk * 16 + k_row) * RS + h * HDP +
                                      k_col) * 2);
        ce::mma_bf16(s[2 * kk], qa, kf[0], kf[1]);
        ce::mma_bf16(s[2 * kk + 1], qa, kf[2], kf[3]);
        if (HDP > 16) {
          uint32_t kf8[2];
          ce::ldmatrix_x2(kf8, k_addr + ((kk * 16 + v_row) * RS + h * HDP +
                                         16) * 2);
          ce::mma_bf16_k8(s[2 * kk], qb[0], qb[1], kf8[0]);
          ce::mma_bf16_k8(s[2 * kk + 1], qb[0], qb[1], kf8[1]);
        }
      }
      // the logits in log2 units: (q k^T + bias / scale) scale log2 e
      float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int j = t * KT + n * 8 + 2 * tig;
        if (j < M) {  // M is even: keys j and j + 1 both exist
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= a.scale_log2;
          if (PLANTS && (a.plant & PLANT_PAD_MASKED)) {
            if (padded(j)) s[n][0] = s[n][2] = neg_inf();
            if (padded(j + 1)) s[n][1] = s[n][3] = neg_inf();
          }
        } else {
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = neg_inf();
        }
        tmax[0] = fmaxf(tmax[0], fmaxf(s[n][0], s[n][1]));
        tmax[1] = fmaxf(tmax[1], fmaxf(s[n][2], s[n][3]));
      }
      float mneg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float mn = fmaxf(mx[pp][r], tmax[r]);
        const float mref = mn == neg_inf() ? 0.f : mn;  // no key (plant)
        const float corr = ce::exp2_approx(mx[pp][r] - mref);
        mx[pp][r] = mn;
        mneg[r] = -mref;
        sum[pp][r] *= corr;
        if (!(PLANTS && (a.plant & PLANT_NO_RESCALE)))
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            o[pp][d][2 * r] *= corr;
            o[pp][d][2 * r + 1] *= corr;
          }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ce::exp2_approx(s[n][e] + mneg[e >> 1]);
          sum[pp][e >> 1] += s[n][e];
        }
      // O += P V, 16 keys a k-step
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        uint32_t vf[4];
        ce::ldmatrix_x4_trans(vf, v_addr + ((kk * 16 + v_row) * RS + h * HDP +
                                            v_col) * 2);
        ce::mma_bf16(o[pp][0], pa, vf[0], vf[1]);
        ce::mma_bf16(o[pp][1], pa, vf[2], vf[3]);
        if (HDP > 16) {
          uint32_t vf8[2];
          ce::ldmatrix_x2_trans(vf8, v_addr + ((kk * 16 + v_row) * RS +
                                               h * HDP + 16) * 2);
          ce::mma_bf16(o[pp][2], pa, vf8[0], vf8[1]);
        }
      }
    }
  }

  // the output tile [NQ][OS] over the ring, once every warp is done
  __syncthreads();
  bf16* out_s = ring;
#pragma unroll
  for (int pp = 0; pp < PPW; ++pp) {
    const int h = h0 + pp * G::HSTEP, r0 = qr + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = sum[pp][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int col = d * 8 + 2 * tig;
        if (col < HD)
          *reinterpret_cast<uint32_t*>(out_s + (r0 + 8 * r) * G::OS +
                                       h * HD + col) =
              pack_bf16(o[pp][d][2 * r] * inv, o[pp][d][2 * r + 1] * inv);
      }
    }
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(a.out + ((size_t)b * N + q0) * C);
  constexpr int VR = C / 8;  // 16-byte vectors a row
  for (int e = tid; e < G::NQ * VR; e += THREADS) {
    const int r = e / VR, v = e - r * VR;
    dst[e] = *reinterpret_cast<const uint4*>(out_s + r * G::OS + v * 8);
  }
}

template <int C, int NH, int WS, int OWS, bool PLANTS = false>
int launch_oca(const OcaArgs& a, long long nb, cudaStream_t s) {
  using G = Geo<C, NH, WS, OWS, PLANTS>;
  const long long blocks = nb * G::SPLIT;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      ce::allow_smem<oca_kernel<C, NH, WS, OWS, PLANTS>>(G::SMEM);
  if (e != cudaSuccess) return (int)e;
  oca_kernel<C, NH, WS, OWS, PLANTS>
      <<<(unsigned)blocks, G::THREADS, G::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of kernel 9 on bf16 q [B * nh_w * nw_w, ws * ws, C] and maps
// [B, hp, wp, C] (hp = nh_w * ws + ows - ws, wp likewise), the f32 bias
// [nh, ws * ws, ows * ows] divided by scale, in fragment order (ops/
// flash_oca.bias_fragments: for head h, query tile qt of 16 rows, key tile
// kn of 8 keys and lane 4 g + t, the float4 of rows 16 qt + g and + 8 at
// keys 8 kn + 2 t and + 1, zero past ows^2), out like q; (C, nh, ws, ows)
// one of the geometries above; scale = hd^-1/2. plant: 0 but in the
// checks that plant faults, which plant them at (120, 6, 16, 24) only.
// Returns the cudaError_t of the launch, cudaErrorInvalidValue for what it
// does not take.
int hat_oca(const void* q, const void* kmap, const void* vmap,
            const void* bias, void* out, int B, int nh_w, int nw_w, int hp,
            int wp, int C, int nh, int ws, int ows, float scale, int plant,
            void* stream) {
  if (B < 1 || nh_w < 1 || nw_w < 1 || hp != nh_w * ws + ows - ws ||
      wp != nw_w * ws + ows - ws)
    return (int)cudaErrorInvalidValue;
  const OcaArgs a{static_cast<const bf16*>(q),
                  static_cast<const bf16*>(kmap),
                  static_cast<const bf16*>(vmap),
                  static_cast<const float4*>(bias),
                  static_cast<bf16*>(out), nh_w, nw_w, hp, wp,
                  scale * LOG2E, plant};
  const long long nb = (long long)B * nh_w * nw_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plant)
    return nh == 6 && C == 120 && ws == 16 && ows == 24
               ? launch_oca<120, 6, 16, 24, true>(a, nb, s)
               : (int)cudaErrorInvalidValue;
  if (nh == 6 && C == 96 && ws == 8 && ows == 12)
    return launch_oca<96, 6, 8, 12>(a, nb, s);
  if (nh == 6 && C == 96 && ws == 8 && ows == 10)
    return launch_oca<96, 6, 8, 10>(a, nb, s);
  if (nh == 6 && C == 96 && ws == 16 && ows == 24)
    return launch_oca<96, 6, 16, 24>(a, nb, s);
  if (nh == 6 && C == 120 && ws == 16 && ows == 24)
    return launch_oca<120, 6, 16, 24>(a, nb, s);
  if (nh == 8 && C == 128 && ws == 8 && ows == 12)
    return launch_oca<128, 8, 8, 12>(a, nb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
