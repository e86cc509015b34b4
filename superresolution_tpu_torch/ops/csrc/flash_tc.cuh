// The port's FlashAttention-2 body on the tensor cores (sm_90a), shared by
// kernel 9 (oca_kernels.cu) and kernel 10's bf16 launches
// (attn_kernels.cu). One body, three ways to address its keys (MODE):
//
//   KEYS_OCA  kernel 9: ws x ws query windows of q [nb, ws^2, C]; key j of
//             window (img, wr, wc) is the pixel (wr ws + j / ows, wc ws +
//             j % ows) of the zero-padded key and value maps [B, hp, wp,
//             C]. The padded keys take part in the softmax.
//   KEYS_WIN  kernel 10 on windows: q [nb, n, C], k, v [nb, m, C] strided
//             views (window and row strides, k's and v's the same; the
//             split of a packed qkv projection read in place), out [nb,
//             n, C] contiguous; the
//             Swin mask from region ids [nw_img, n] (window b reads row b
//             % nw_img) where given.
//   KEYS_MAP  kernel 10 on the map (the HAB's self-attention): q, k and v
//             read straight from the qkv map [B, H, W, 3C] (q | k | v),
//             the shift as index arithmetic: token (tr, tc) of window
//             (wr, wc) is the pixel ((wr ws + tr + s) mod H, (wc ws + tc +
//             s) mod W), kernel 11's address map; each output token is
//             written back to the pixel it came from, out [B, H, W, C].
//             With a shift the region ids come from the rolled-frame
//             position (wr ws + tr, wc ws + tc), whose regions on a side
//             of L are [0, L - ws), [L - ws, L - s), [L - s, L), as
//             models/hat_lite.shift_region_ids lays them out. No roll,
//             partition or merge is ever written.
//
// Per query window and head h, with head dim hd = C / nh and scale =
// hd^-1/2:  out_h = softmax(q_h k_h^T scale + bias[h] (- 1e9 where the
// region ids of query and key differ)) v_h. Logits and softmax in f32;
// each probability is rounded to bf16 before its product with v (the
// reference rounds its probabilities to the input type), here before the
// final division by the row sum, which the online form applies last.
//
// Design (FlashAttention-2 on mma.sync):
// - One block a window's NQ = 64 queries, all heads: one block a window
//   at n 64, four at n 256 (adjacent in the grid, so the three after the
//   first find the keys in L2). A warp takes PPW (head, 16-query tile)
//   pairs (3 at C 96: 8 warps; 2 at C 128: 16; 1 at C 120: 24; see
//   PPW_CAP), one query tile at heads a fixed stride apart, and holds
//   each one's output accumulators, row max and row sum in registers for
//   the block's life; q is staged in shared memory with the first key
//   tile.
// - The m keys stream through a ring of NSTAGE shared-memory stages in
//   tiles of KT keys. A tile stages whole key rows, all heads, k and v,
//   with 16-byte cp.async (8-byte at head dim 20, whose heads start at
//   40-byte offsets), into rows of NH * HDP + 8 elements: each head
//   padded to HDP = 16 or 24 columns (the pad columns zero), so every
//   ldmatrix row starts 16-byte aligned and the 8 rows of an ldmatrix
//   fall on distinct banks. Keys past m are zero rows whose logits are
//   -inf.
// - S = Q K^T: mma.sync m16n8k16 (and an m16n8k8 over the pad at head
//   dim 20), bf16 in, f32 sums; K's B fragments by ldmatrix. The
//   accumulators start from the bias / scale re-laid into the
//   accumulator's layout (ops/flash_oca.bias_fragments; one 16-byte load
//   a lane and 8-key tile, straight into the accumulator registers), so
//   the logit in log2 units is one multiply, acc * scale log2 e; the
//   Swin mask adds -1e9 log2 e where the ids differ, which underflows to
//   exactly 0 once a row's max is an unmasked logit (every query shares
//   its own region). Then the online softmax (online_softmax below): the
//   tile's row max over the quad of lanes that hold a row, the rescale of
//   the running sum and output by 2^(m_old - m_new), and p = 2^(s - m) on
//   the special-function unit.
// - O += P V: P's accumulators, rounded to bf16 pairs, are the A
//   fragments in registers (p_fragment); V's B fragments come by
//   ldmatrix.trans.
// - The end: O / row sum, staged as bf16 in shared memory and written as
//   16-byte stores (8-byte where C is not a multiple of 8), one run of C
//   channels a query row.
// - Widths: any C = nh hd up to 128 at head dim 16 and 120 at 20 (one
//   instance a (C, nh)); the pairs a warp take the largest divisor of nh
//   up to the cap, so widths with a prime head count past 3 run one pair
//   a warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_engine.cuh"

namespace flash_tc {

namespace ce = conv_engine;
using ce::bf16;

enum { KEYS_OCA = 0, KEYS_WIN = 1, KEYS_MAP = 2 };

// Faults the checks in chip_smoke.py plant (0 in every other launch), in
// the one PLANTS instance of each mode that takes them.
constexpr int PLANT_PAD_MASKED = 1;   // 9: the padded keys masked out of
                                      // the softmax (logit -inf)
constexpr int PLANT_NO_RESCALE = 2;   // 9: the output not rescaled when a
                                      // key tile raises the row max
constexpr int PLANT_ROW_STRIDE = 4;   // 9: map rows addressed at a stride
                                      // of wp - 1 pixels
constexpr int PLANT_NO_MASK = 1;      // 10: the Swin mask dropped
constexpr int PLANT_CLAMP = 2;        // 10 (map): the shifted address
                                      // clamped to the map, not wrapped
constexpr int PLANT_SKIP_LAST = 4;    // 10: the last key tile skipped

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
constexpr float NEG_LOG2 = -1e9f * LOG2E;  // the Swin mask, log2 units

struct FlashArgs {
  const bf16* q;       // OCA, WIN: [nb, n, C] (WIN: strided); MAP: the
                       // qkv map [B, H, W, 3C]
  const bf16* k;       // OCA: the key map [B, hp, wp, C]; WIN: [nb, m, C]
  const bf16* v;
  long long q_bs, q_rs, k_bs, k_rs;  // WIN: strides, elements (v: k's)
  const float4* bias;  // [nh, n, m] in fragment order (see below)
  const int* ids;      // WIN: [nw_img, n] region ids, or null
  int nw_img;
  bf16* out;           // OCA, WIN: [nb, n, C]; MAP: [B, H, W, C]
  int nh_w, nw_w;      // windows a column and a row of an image
  int hp, wp;          // OCA: the padded maps' H, W; MAP: the map's H, W
  int shift;           // MAP: the Swin shift (0: none)
  int m;               // WIN at OWS 0: keys a window
  float scale_log2;    // hd^-1/2 log2 e
  int plant;
};

// N = WS^2 queries, M = OWS^2 keys a window (every geometry of kernels 9
// and 10 is square: 8x8 and 16x16 windows against 8, 10, 11, 12, 16 and
// 24 on a side); OWS 0 (KEYS_WIN only): the windows' m keys are read from
// FlashArgs::m at run time, so that one instance serves every key count
// of a width. PLANTS: the instance that takes the planted faults (only
// the checks launch it, at one geometry); the others carry no code for
// them.
template <int C, int NH, int WS, int OWS, int MODE, bool PLANTS>
struct Geo {
  static constexpr int HD = C / NH;
  static constexpr int HDP = (HD + 7) / 8 * 8;  // 16, or 24 at head dim 20
  static constexpr int N = WS * WS;
  static constexpr int M = OWS * OWS;
  static constexpr int NQ = N < NQ_MAX ? N : NQ_MAX;
  static constexpr int SPLIT = N / NQ;          // blocks a window
  static constexpr int QT = NQ / 16;            // query tiles a block
  static constexpr int PAIRS = NH * QT;
  // pairs a warp, all of one query tile: the largest divisor of NH up to
  // the cap
  static constexpr int CAP = HD == 16 ? PPW_CAP : PPW_CAP_HD20;
  static constexpr int PPW = NH % CAP == 0                  ? CAP
                             : CAP > 2 && NH % (CAP - 1) == 0 ? CAP - 1
                                                              : 1;
  static constexpr int WARPS = PAIRS / PPW;
  static constexpr int THREADS = 32 * WARPS;
  // at least 128 registers a thread
  static constexpr int MIN_BLOCKS =
      PLANTS || 512 / THREADS < 1 ? 1
      : 512 / THREADS < BLOCKS_CAP ? 512 / THREADS : BLOCKS_CAP;
  static constexpr int RS = NH * HDP + 8;       // staged key row, elements
  static constexpr int DT = HDP / 8;            // 8-column tiles of a head
  // output tile row stride: 16-byte rows; the 8 rows of a fragment store
  // on distinct banks
  static constexpr int OS = (C + 8) % 64 == 0 ? C + 16 : C + 8;
  // elements a store of an output row: 8 (16 bytes), or 4 where C is not a
  // multiple of 8 (C 20, 60, 100)
  static constexpr int VW = C % 8 == 0 ? 8 : 4;
  static constexpr size_t STAGE = (size_t)2 * KT * RS * 2;  // k and v
  static constexpr size_t QBYTES = (size_t)NQ * RS * 2;     // q, as k
  static constexpr size_t RING = NSTAGE * STAGE > (size_t)NQ * OS * 2
                                     ? NSTAGE * STAGE
                                     : (size_t)NQ * OS * 2;
  // then N ints: the window's region ids (WIN, MAP) and, for MAP, N more:
  // each token's pixel
  static constexpr size_t SMEM =
      QBYTES + RING + (MODE == KEYS_OCA ? 0 : (size_t)2 * N * 4);
  static_assert(C % NH == 0 && (HD == 16 || HD == 20), "head dim");
  // warp w takes query tile w % QT of heads w / QT + pp HSTEP, pp < PPW:
  // its pairs' offsets differ by compile-time strides
  static constexpr int HSTEP = WARPS / QT;
  static_assert(N % NQ == 0 && NQ % 16 == 0 && PPW * WARPS == PAIRS &&
                    WARPS % QT == 0 && PPW * HSTEP == NH && THREADS <= 1024,
                "query tiles");
  static_assert(KT % 16 == 0 && (MODE != KEYS_OCA || M % 2 == 0) &&
                    (OWS > 0 || MODE == KEYS_WIN),
                "key tiles");
  static_assert(MODE != KEYS_OCA || (OWS > WS && (OWS - WS) % 2 == 0),
                "overlap");
  static_assert(MODE != KEYS_MAP || OWS == WS, "self-attention");
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One key tile's step of the online softmax for one 16-row query tile:
// s [NT 8-key fragments][4] holds the tile's logits in log2 units (-inf
// where there is no key), in mma.sync's accumulator layout (element e of
// fragment n is row g + 8 (e >> 1), key 8 n + 2 tig + (e & 1)), tmax this
// lane's maxima of them; mx, sum the running row max and per-lane sum of
// rows g and g + 8, o the output accumulators [DT 8-column
// fragments][4]. Raises the row max to the tile's (over the quad of lanes
// that hold a row), rescales sum and o by 2^(m_old - m_new) (not with
// `no_rescale`, a planted fault), and replaces each logit by p = 2^(s -
// m), adding it to sum.
// tmax: the tile's row maxima of this lane's logits (tile_max), which a
// caller may also take while it writes them.
template <int NT>
__device__ __forceinline__ void tile_max(const float (&s)[NT][4],
                                         float (&tmax)[2]) {
  tmax[0] = tmax[1] = neg_inf();
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    tmax[0] = fmaxf(tmax[0], fmaxf(s[n][0], s[n][1]));
    tmax[1] = fmaxf(tmax[1], fmaxf(s[n][2], s[n][3]));
  }
}

template <int NT, int DT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&tmax)[2],
                                               float (&mx)[2],
                                               float (&sum)[2],
                                               float (&o)[DT][4],
                                               bool no_rescale = false) {
  float mneg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float mn = fmaxf(mx[r], tmax[r]);
    const float mref = mn == neg_inf() ? 0.f : mn;  // no key yet
    const float corr = ce::exp2_approx(mx[r] - mref);
    mx[r] = mn;
    mneg[r] = -mref;
    sum[r] *= corr;
    if (!no_rescale)
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * r] *= corr;
        o[d][2 * r + 1] *= corr;
      }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = ce::exp2_approx(s[n][e] + mneg[e >> 1]);
      sum[e >> 1] += s[n][e];
    }
}

// The A fragment of P V's k-step kk (keys 16 kk .. 16 kk + 15) from the
// probabilities in s, rounded to bf16 pairs.
template <int NT>
__device__ __forceinline__ void p_fragment(const float (&s)[NT][4], int kk,
                                           uint32_t (&pa)[4]) {
  pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// The row sums of rows g and g + 8 over the quad of lanes that hold them.
__device__ __forceinline__ float quad_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  return l + __shfl_xor_sync(0xffffffffu, l, 2);
}

// Region of coordinate v on a side of len in the rolled frame (see the
// file's header).
__device__ __forceinline__ int region(int v, int len, int ws, int shift) {
  return (v >= len - ws) + (v >= len - shift);
}

template <int C, int NH, int WS, int OWS, int MODE, bool PLANTS>
__global__ void __launch_bounds__(
    Geo<C, NH, WS, OWS, MODE, PLANTS>::THREADS,
    Geo<C, NH, WS, OWS, MODE, PLANTS>::MIN_BLOCKS)
    flash_kernel(const FlashArgs a) {
  using G = Geo<C, NH, WS, OWS, MODE, PLANTS>;
  constexpr int HD = G::HD, HDP = G::HDP, N = G::N, RS = G::RS;
  constexpr int PPW = G::PPW, DT = G::DT, NT = KT / 8;
  constexpr int THREADS = G::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int* ids_s = reinterpret_cast<int*>(smem + G::QBYTES + G::RING);  // [N]
  int* pix_s = ids_s + N;  // MAP: [N] each token's pixel
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // fragment row, column pair
  // keys a window, their 8-key bias tiles and KT-key tiles (compile-time
  // constants but at OWS 0)
  const int M = OWS > 0 ? G::M : a.m;
  const int MT = (M + 7) / 8, TILES = (M + KT - 1) / KT;
  constexpr int KW = OWS > 0 ? OWS : 1;  // OCA: the key window's side

  const long long b = blockIdx.x / G::SPLIT;         // the window
  const int q0 = (int)(blockIdx.x % G::SPLIT) * G::NQ;  // its first query
  const int per_img = a.nh_w * a.nw_w;
  const int img = (int)(b / per_img), wi = (int)(b % per_img);
  const int wr = wi / a.nw_w, wc = wi % a.nw_w;
  const int rs = MODE == KEYS_OCA && PLANTS && (a.plant & PLANT_ROW_STRIDE)
                     ? a.wp - 1 : a.wp;
  const long long corner = ((long long)img * a.hp + wr * WS) * rs + wc * WS;
  const bf16* kmap = a.k + corner * C;  // OCA: the window's patch corner
  const bf16* vmap = a.v + corner * C;
  bool masked = false;
  if (MODE == KEYS_WIN && a.ids != nullptr) {
    masked = true;
    for (int t = tid; t < N; t += THREADS)
      ids_s[t] = a.ids[(size_t)(b % a.nw_img) * N + t];
  } else if (MODE == KEYS_MAP) {
    masked = a.shift != 0;
    const bool clamp = PLANTS && (a.plant & PLANT_CLAMP);
    for (int t = tid; t < N; t += THREADS) {
      const int rr = wr * WS + t / WS, cc = wc * WS + t % WS;
      int r = rr + a.shift, c = cc + a.shift;
      if (clamp) {  // read the edge in place of the wrap
        r = min(r, a.hp - 1);
        c = min(c, a.wp - 1);
      } else {
        r -= r >= a.hp ? a.hp : 0;
        c -= c >= a.wp ? a.wp : 0;
      }
      pix_s[t] = (img * a.hp + r) * a.wp + c;
      ids_s[t] = region(rr, a.hp, WS, a.shift) * 3 +
                 region(cc, a.wp, WS, a.shift);
    }
  }
  if (PLANTS && (a.plant & PLANT_NO_MASK)) masked = false;
  if (MODE != KEYS_OCA) __syncthreads();  // ids_s, pix_s

  // where the block's query row r and key j live: qbase + q_off(r), and
  // kbase, vbase + kv_off(j) (on windows k and v share their strides)
  const bf16* qbase = MODE == KEYS_MAP   ? a.q
                      : MODE == KEYS_WIN ? a.q + b * a.q_bs + q0 * a.q_rs
                                         : a.q + ((size_t)b * N + q0) * C;
  const bf16* kbase = MODE == KEYS_MAP   ? a.q + C
                      : MODE == KEYS_WIN ? a.k + b * a.k_bs
                                         : kmap;
  const bf16* vbase = MODE == KEYS_MAP   ? a.q + 2 * C
                      : MODE == KEYS_WIN ? a.v + b * a.k_bs
                                         : vmap;
  auto q_off = [&](int r) -> long long {
    if (MODE == KEYS_MAP) return (long long)pix_s[q0 + r] * (3 * C);
    if (MODE == KEYS_WIN) return r * a.q_rs;
    return (long long)r * C;
  };
  auto kv_off = [&](int j) -> long long {
    if (MODE == KEYS_MAP) return (long long)pix_s[j] * (3 * C);
    if (MODE == KEYS_WIN) return j * a.k_rs;
    return ((long long)(j / KW) * rs + j % KW) * C;
  };

  // element c of a token in a staged row: head c / HD, column c % HD
  constexpr int GW = HD == 16 ? 8 : 4;  // elements a copy
  constexpr int GR = C / GW;            // copies a token
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
        const long long src = kv_off(j) + col;
        copy(ks + dst, kbase + src);
        copy(vs + dst, vbase + src);
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
  for (int e = tid; e < G::NQ * GR; e += THREADS) {
    const int r = e / GR, col = (e - r * GR) * GW;
    copy(qs + r * RS + put(col), qbase + q_off(r) + col);
  }
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < TILES) stage(s, s);
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
  // this lane's query rows' region ids (self-attention only)
  constexpr bool MAY_MASK = MODE != KEYS_OCA && (WS == OWS || OWS == 0);
  const int id_r[2] = {MAY_MASK && masked ? ids_s[q0 + qr + g] : 0,
                       MAY_MASK && masked ? ids_s[q0 + qr + g + 8] : 0};
  // a padded key (outside the image) for kernel 9's planted mask
  const int pad = (OWS - WS) / 2;
  auto padded = [&](int j) {
    const int y = wr * WS + j / KW, x = wc * WS + j % KW;
    return y < pad || y >= a.hp - pad || x < pad || x >= a.wp - pad;
  };
  const bool skip_last = PLANTS && (a.plant & PLANT_SKIP_LAST) &&
                         MODE != KEYS_OCA;
  const bool no_rescale = PLANTS && (a.plant & PLANT_NO_RESCALE) &&
                          MODE == KEYS_OCA;
  // ldmatrix rows of this lane: K (non-trans) key (lane & 7) + 8 (lane
  // >> 4), column 8 ((lane >> 3) & 1); Q, V (trans) and the x2 forms row
  // (lane & 7) + 8 ((lane >> 3) & 1), column 8 (lane >> 4)
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) << 3;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) << 3;

  for (int t = 0; t < TILES; ++t) {
    ce::cp_async_wait<NSTAGE - 2>();  // tile t has landed
    __syncthreads();                  // ... for every thread; the stage of
                                      // tile t - 1 is free
    if (t + NSTAGE - 1 < TILES)
      stage(t + NSTAGE - 1, (t + NSTAGE - 1) % NSTAGE);
    ce::cp_async_commit();
    if (skip_last && t + 1 == TILES) continue;
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
          a.bias + (((size_t)h * (N / 16) + row / 16) * MT + t * (KT / 8)) *
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
      // the logits in log2 units: (q k^T + bias / scale) scale log2 e,
      // -inf past the keys, the mask's -1e9 log2 e off-region; and their
      // row maxima
      float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int j = t * KT + n * 8 + 2 * tig;
        if constexpr (MODE == KEYS_OCA) {
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
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = j + (e & 1);
            float v = s[n][e] * a.scale_log2;
            if (jj >= M)
              v = neg_inf();
            else if (MAY_MASK && masked && id_r[e >> 1] != ids_s[jj])
              v += NEG_LOG2;
            s[n][e] = v;
          }
        }
        tmax[0] = fmaxf(tmax[0], fmaxf(s[n][0], s[n][1]));
        tmax[1] = fmaxf(tmax[1], fmaxf(s[n][2], s[n][3]));
      }
      online_softmax<NT, DT>(s, tmax, mx[pp], sum[pp], o[pp], no_rescale);
      // O += P V, 16 keys a k-step
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t pa[4];
        p_fragment<NT>(s, kk, pa);
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
      const float inv = 1.f / quad_sum(sum[pp][r]);
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
  constexpr int VW = G::VW, VR = C / VW;  // a store's elements; a row's
  using Vec = std::conditional_t<VW == 8, uint4, uint2>;
  if constexpr (MODE == KEYS_MAP) {  // each row back to its pixel
    for (int e = tid; e < G::NQ * VR; e += THREADS) {
      const int r = e / VR, v = e - r * VR;
      *reinterpret_cast<Vec*>(a.out + (size_t)pix_s[q0 + r] * C + v * VW) =
          *reinterpret_cast<const Vec*>(out_s + r * G::OS + v * VW);
    }
  } else {  // the block's rows are one contiguous run
    Vec* dst = reinterpret_cast<Vec*>(a.out + ((size_t)b * N + q0) * C);
    for (int e = tid; e < G::NQ * VR; e += THREADS) {
      const int r = e / VR, v = e - r * VR;
      dst[e] = *reinterpret_cast<const Vec*>(out_s + r * G::OS + v * VW);
    }
  }
}

// One launch over nb windows; cudaErrorInvalidValue past the grid.
template <int C, int NH, int WS, int OWS, int MODE, bool PLANTS = false>
int launch(const FlashArgs& a, long long nb, cudaStream_t s) {
  using G = Geo<C, NH, WS, OWS, MODE, PLANTS>;
  const long long blocks = nb * G::SPLIT;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      ce::allow_smem<flash_kernel<C, NH, WS, OWS, MODE, PLANTS>>(G::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_kernel<C, NH, WS, OWS, MODE, PLANTS>
      <<<(unsigned)blocks, G::THREADS, G::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 10 at a width other than the model's (attn_tc_widths16.cu,
// attn_tc_widths20.cu): on windows (KEYS_WIN) of ws x ws queries with the
// keys a window read from a.m, or on the map (KEYS_MAP), ws 8 or 16.
template <int C, int NH>
int launch_width(const FlashArgs& a, int mode, long long nb, int ws,
                 cudaStream_t s) {
  if (ws != 8 && ws != 16) return (int)cudaErrorInvalidValue;
  if (mode == KEYS_WIN)
    return ws == 8 ? launch<C, NH, 8, 0, KEYS_WIN>(a, nb, s)
                   : launch<C, NH, 16, 0, KEYS_WIN>(a, nb, s);
  return ws == 8 ? launch<C, NH, 8, 8, KEYS_MAP>(a, nb, s)
                 : launch<C, NH, 16, 16, KEYS_MAP>(a, nb, s);
}

// The widths' launches by head count: head dim 16 at 1-5 and 7 heads,
// head dim 20 at 1-5 (the model's (C, heads) (96, 6), (128, 8) and (120,
// 6) have instances of their own in attn_tc_kernels.cu).
int launch_width16(const FlashArgs& a, int mode, long long nb, int ws,
                   int nh, cudaStream_t s);
int launch_width20(const FlashArgs& a, int mode, long long nb, int ws,
                   int nh, cudaStream_t s);

}  // namespace flash_tc
