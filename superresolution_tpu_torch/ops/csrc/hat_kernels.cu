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
//      hab_kernel<..., false>, one thread block per window. LN1 -> qkv ->
//      per head softmax(q k^T hd^-1/2 + rpb[h] (+ -1e9 where region ids
//      differ)) v -> proj -> x1 = x + proj + cab -> LN2 -> fc1 -> exact
//      GELU -> fc2 -> x1 + o, with every intermediate in shared memory and
//      the weights read through L1/L2. Templated on (C, heads, tokens n,
//      MLP hidden), instantiated for (96, 6, 64, 192), (96, 6, 256, 192),
//      (120, 6, 256, 240) and the lane-padded (128, 8, 64, 192): 8x8 and
//      16x16 windows, head dim 16 and 20. Both LNs divide by c_real.
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
//  12 fused_cab_convs_pair  (replaces ops/pallas_hab.py:
//      fused_cab_convs_pair / _cab_pair_kernel): kernel 7's function in
//      one launch, cab_pair_kernel. A block takes a TH x TW output tile:
//      LN of the tile and a 2-pixel halo into shared memory as bf16 (zero
//      outside the image: SAME padding of conv1), conv1 + bias + GELU on
//      the tile and a 1-pixel halo into a shared hidden tile (zero outside
//      the image: SAME padding of conv2, the reference's mask(acc, 1)),
//      conv2 + bias to the output. Each thread computes two horizontally
//      adjacent pixels of 8 output channels, sharing the four input
//      columns the pair reads: Hopper's form of the reference's 2-column
//      phase packing, which exists to fill the MXU. Nothing but x and the
//      output crosses device memory.
//   (Kernel 9, the OCAB's gathered attention, is in attn_kernels.cu: it
//      shares kernel 10's attention body.)
//
// Kernel 8's shared memory: at n 256 a whole window's five [n, C+8] bf16
// tiles would take 266 KB (C 96) or 328 KB (C 120), beyond the 227 KB a
// block may have. So the block first computes LN1 and k, v of all n
// tokens, 64 rows at a time, into [n, C+8] K and V tiles that stay for
// the block's life (131 KB at n 256, C 120); then for each tile of 64
// query rows it recomputes LN1, computes q, attends over all n keys with
// an online softmax (the keys in steps of KC per lane: no lane holds more
// than KC logits), and runs proj, LN2 and the MLP on the tile. The
// recomputed LN1 costs 2% of the block's operations. Rows of C = 120
// (head dim 20) are not a multiple of 32 lanes: the LN and product loops
// mask the columns past C, and a head's columns are read as bf16 pairs
// (4-byte aligned at every head dim here). At the lane-padded C 128 the
// block takes 111 KB; its pad heads read zero q, k and v columns, so they
// attend uniformly over zero values and write exactly zero, and every pad
// lane of the output stays zero (zero weights, biases and LN parameters).
//
// Rounding follows the reference: f32 accumulation and f32 softmax; bf16
// stores of LN outputs, q, k, v, the probabilities, the attention output,
// proj, x1, the MLP hidden and o. The probabilities are rounded before
// the online softmax's final normalisation. The -1e9 mask underflows to
// exactly 0 in expf.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s; ridge ~295 FLOP/B):
// the HAB does C (3C + C + 2 MLP) + 2 n C MACs per token for 6 C bytes
// (x, cab, out) -- 86,016 MACs for 576 bytes at (96, 64, 192), 299
// FLOP/B, and more at n 256; kernel 11 the same; the CAB (kernels 7 and
// 12) 55,296 MACs per pixel for 384 bytes at C 96, 288 FLOP/B. All sit at
// or near the ridge, so a fast form needs both the tensor cores and one
// pass over memory. These first forms run every product on the CUDA
// cores in f32 FMA (67 TFLOP/s peak), so they can reach at most ~7% of
// the operation bound; they do keep the one pass: kernels 8 and 11 read
// each activation once and write each output once, kernel 12 reads x and
// writes the output only, and kernel 7 writes LN(x) and its hidden map
// besides.
//
// Planted faults (`plant`, a bit mask; 0 in use) let a check show it sees
// what it holds: kernel 11 PLANT_CLAMP (x and cab_y read at coordinates
// clamped to the map instead of wrapped), PLANT_NO_SE (cab_y unscaled),
// PLANT_NO_MASK (no region mask); kernel 12 PLANT_HID_BORDER (the hidden
// map not zeroed outside the image), PLANT_SWAP_PAIR (the two pixels of a
// pair swapped).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-5f;
constexpr float kNeg = -1e9f;
constexpr int NT = 256;         // threads per block
constexpr int RT = 64;          // rows per tile of kernel 8 (4 lanes a row)
constexpr int KC = 8;           // keys a lane takes per online-softmax step

enum {
  PLANT_CLAMP = 1, PLANT_NO_SE = 2, PLANT_NO_MASK = 4,   // kernel 11
  PLANT_HID_BORDER = 1, PLANT_SWAP_PAIR = 2,             // kernel 12
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

// [RT, K] (smem, row stride lda) @ [K, N] (global, row stride LDW) with
// f32 accumulation. Warp w owns rows 8w..8w+7 and lane l the columns
// l + 32j (masked past N), so a warp reads 32 consecutive weights per row
// of W and one broadcast A value per row. epi(row, col, acc) sees every
// output once.
template <int K, int N, int LDW, typename Epi>
__device__ __forceinline__ void gemm_rows(const bf16* A, int lda,
                                          const bf16* __restrict__ W,
                                          Epi epi) {
  constexpr int RM = RT / (NT / 32);
  constexpr int NJ = (N + 31) / 32;
  static_assert(K % 2 == 0, "gemm_rows: K must be even");
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * RM;
  float acc[RM][NJ];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 2) {
    float2 av[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      av[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          A + (r0 + r) * lda + k));
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      const float w0 = col < N ? f(W[k * LDW + col]) : 0.f;
      const float w1 = col < N ? f(W[(k + 1) * LDW + col]) : 0.f;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        acc[r][j] = fmaf(av[r].x, w0, acc[r][j]);
        acc[r][j] = fmaf(av[r].y, w1, acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (lane + 32 * j < N) epi(r0 + r, lane + 32 * j, acc[r][j]);
}

// One head (columns c0..c0+HD) of softmax attention for the tile's RT
// query rows (qs) over NK keys (ks, vs), all bf16 smem tiles of row
// stride lda. Row i = tid / 4 is held by four lanes; lane g takes the
// keys g, g + 4, ... in steps of KC with an online softmax (f32 logits,
// running max and sum, probabilities rounded to bf16 before the product
// with v); the four lanes merge and lane g stores head dims
// g*HD/4 .. (g+1)*HD/4 - 1 of the row into outs.
template <int HD, int NK, typename Bias>
__device__ __forceinline__ void attend_rows(const bf16* qs, const bf16* ks,
                                            const bf16* vs, int lda, int c0,
                                            float scale, Bias bias,
                                            bf16* outs) {
  static_assert(HD % 4 == 0, "head dim");
  const int i = threadIdx.x >> 2, g = threadIdx.x & 3;
  float q[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 2) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(qs + i * lda + c0 + d));
    q[d] = t.x;
    q[d + 1] = t.y;
  }
  float mx = __int_as_float(0xff800000);  // -inf
  float l = 0.f;
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  for (int j0 = g; j0 < NK; j0 += 4 * KC) {
    float s[KC];
    float cm = __int_as_float(0xff800000);
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      const int j = j0 + 4 * u;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        const float2 t = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ks + j * lda + c0 + d));
        acc = fmaf(q[d], t.x, acc);
        acc = fmaf(q[d + 1], t.y, acc);
      }
      s[u] = acc * scale + bias(i, j);
      cm = fmaxf(cm, s[u]);
    }
    const float mn = fmaxf(mx, cm);
    const float corr = expf(mx - mn);  // 0 on the first step
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] *= corr;
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      const int j = j0 + 4 * u;
      const float p = expf(s[u] - mn);
      l += p;
      const float pr = rbf(p);
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        const float2 t = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vs + j * lda + c0 + d));
        o[d] = fmaf(pr, t.x, o[d]);
        o[d + 1] = fmaf(pr, t.y, o[d + 1]);
      }
    }
    mx = mn;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, mx, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(mx, mo);
    const float fa = expf(mx - mn), fb = expf(mo - mn);
    l = l * fa + lo * fb;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const float od = __shfl_xor_sync(0xffffffffu, o[d], off);
      o[d] = o[d] * fa + od * fb;
    }
    mx = mn;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d)
    if (d / (HD / 4) == g) outs[i * lda + c0 + d] = __float2bfloat16(o[d] / l);
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

// ---- kernels 8 and 11: the HAB block body, one block per window --------
struct HabArgs {
  const bf16* x;            // kernel 8: [nb, n, C] windows; 11: [B,H,W,C]
  const bf16* cab;          // the same layout; kernel 8: conv_scale applied
  bf16* out;                // the same layout
  const float* ln1_s;       // [C]
  const float* ln1_b;
  const bf16* wqkv;         // [C, 3C], columns q | k | v
  const float* bqkv;        // [3C]
  const float* rpb;         // [heads, n, n]
  const bf16* wp;           // [C, C]
  const float* bp;
  const float* ln2_s;
  const float* ln2_b;
  const bf16* w1;           // [C, MLP]
  const float* b1;
  const bf16* w2;           // [MLP, C]
  const float* b2;
  const int* ids;           // kernel 8: [nw_img, n] region ids, or null
  int nw_img;
  float scale;              // head_dim ** -0.5
  int c_real;               // the LNs' divisor: C, or the unpadded C
  // kernel 11
  const float* se;          // [B, C]: sigmoid(SE) * conv_scale
  int H, W, shift, plant;
};

template <int C, int N, int MLP>
constexpr size_t hab_smem() {
  return (size_t)(2 * N * (C + 8) + 3 * RT * (C + 8) + RT * (MLP + 8)) *
             sizeof(bf16) +
         3 * N * sizeof(int);
}

__device__ __forceinline__ int region(int v, int len, int ws, int shift) {
  return (v >= len - ws) + (v >= len - shift);
}

template <int C, int NH, int N, int MLP, bool STRIP>
__global__ void __launch_bounds__(NT) hab_kernel(const HabArgs a) {
  constexpr int LDA = C + 8;      // smem row stride (bf16) of [*, C] tiles
  constexpr int LDH = MLP + 8;    // smem row stride of the MLP hidden tile
  constexpr int HD = C / NH;
  constexpr int WS = N == 64 ? 8 : 16;
  static_assert(N % RT == 0 && C % NH == 0 && WS * WS == N, "geometry");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [N, LDA] keys of the window
  bf16* vs = ks + N * LDA;                   // [N, LDA] values
  bf16* xs = vs + N * LDA;   // [RT, LDA] x of the tile, then x1
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
  __syncthreads();
  // k and v of every token of the window
  for (int t0 = 0; t0 < N; t0 += RT) {
    load_tile<C>(xs, LDA, a.x, rd + t0, RT);
    __syncthreads();
    ln_rows<C>(xs, ys, LDA, RT, a.c_real, a.ln1_s, a.ln1_b);
    __syncthreads();
#pragma unroll
    for (int p = 1; p < 3; ++p) {
      bf16* dst = p == 1 ? ks : vs;
      gemm_rows<C, C, 3 * C>(ys, LDA, a.wqkv + p * C,
                             [&](int r, int c, float acc) {
        dst[(t0 + r) * LDA + c] = __float2bfloat16(acc + a.bqkv[p * C + c]);
      });
    }
    __syncthreads();
  }
  // each tile of RT query rows through attention, proj and the MLP
  for (int t0 = 0; t0 < N; t0 += RT) {
    load_tile<C>(xs, LDA, a.x, rd + t0, RT);
    __syncthreads();
    ln_rows<C>(xs, ys, LDA, RT, a.c_real, a.ln1_s, a.ln1_b);
    __syncthreads();
    gemm_rows<C, C, 3 * C>(ys, LDA, a.wqkv, [&](int r, int c, float acc) {
      qs[r * LDA + c] = __float2bfloat16(acc + a.bqkv[c]);
    });
    __syncthreads();
    for (int h = 0; h < NH; ++h)
      attend_rows<HD, N>(
          qs, ks, vs, LDA, h * HD, a.scale,
          [&](int i, int j) {
            const float v = a.rpb[((size_t)h * N + t0 + i) * N + j];
            return masked && ids[t0 + i] != ids[j] ? v + kNeg : v;
          },
          ys);
    __syncthreads();
    gemm_rows<C, C, C>(ys, LDA, a.wp, [&](int r, int c, float acc) {
      const float t = rbf(f(xs[r * LDA + c]) + rbf(acc + a.bp[c]));
      float cv = f(a.cab[(size_t)rd[t0 + r] * C + c]);
      if (STRIP && !(a.plant & PLANT_NO_SE)) cv = rbf(cv * se[c]);
      xs[r * LDA + c] = __float2bfloat16(t + cv);
    });
    __syncthreads();
    ln_rows<C>(xs, ys, LDA, RT, a.c_real, a.ln2_s, a.ln2_b);
    __syncthreads();
    gemm_rows<C, MLP, MLP>(ys, LDA, a.w1, [&](int r, int c, float acc) {
      hs[r * LDH + c] = __float2bfloat16(gelu_erf(acc + a.b1[c]));
    });
    __syncthreads();
    gemm_rows<MLP, C, C>(hs, LDH, a.w2, [&](int r, int c, float acc) {
      a.out[(size_t)pix[t0 + r] * C + c] =
          __float2bfloat16(f(xs[r * LDA + c]) + rbf(acc + a.b2[c]));
    });
    __syncthreads();  // before the next tile overwrites xs and hs
  }
}

template <int C, int NH, int N, int MLP, bool STRIP>
int launch_hab(const HabArgs& a, int nb, cudaStream_t stream) {
  constexpr size_t bytes = hab_smem<C, N, MLP>();
  cudaError_t e = cudaFuncSetAttribute(
      hab_kernel<C, NH, N, MLP, STRIP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
  a.wqkv = static_cast<const bf16*>(w[2]);
  a.bqkv = static_cast<const float*>(w[3]);
  a.rpb = static_cast<const float*>(w[4]);
  a.wp = static_cast<const bf16*>(w[5]);
  a.bp = static_cast<const float*>(w[6]);
  a.ln2_s = static_cast<const float*>(w[7]);
  a.ln2_b = static_cast<const float*>(w[8]);
  a.w1 = static_cast<const bf16*>(w[9]);
  a.b1 = static_cast<const float*>(w[10]);
  a.w2 = static_cast<const bf16*>(w[11]);
  a.b2 = static_cast<const float*>(w[12]);
  a.scale = scale;
  a.c_real = c_real;
  return a;
}

// ---- kernel 12: the CAB's LN -> conv -> GELU -> conv in one launch -----
constexpr int PT_H = 8;           // output rows of a tile
constexpr int PT_W = 32;          // output columns of a tile
constexpr int PO = 8;             // output channels a thread takes

template <int C>
__host__ __device__ constexpr int ln_ld() { return C + 2; }  // odd words
template <int C>
constexpr size_t pair_smem() {
  return ((size_t)(PT_H + 4) * (PT_W + 4) * ln_ld<C>() +
          (size_t)(PT_H + 2) * (PT_W + 2) * ln_ld<C / 3>()) *
         sizeof(bf16);
}

// Eight bf16 (16 bytes, element 2k the low half of word k) -> f32.
__device__ __forceinline__ void bf16x8(const uint4 u, float* o) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = __uint_as_float(w[k] << 16);
    o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// One conv3x3 stage of kernel 12 over an (RO x CO)-pixel region of
// pairs: in [(RO+2) x (CO+2), LDI] smem bf16, w [3,3,CI,CN] HWIO bf16 in
// device memory. Item = (pair, group of PO output channels); the pair's
// two pixels read the same four input columns of each of the three rows.
// epi(row, col, channel, acc) stores each output.
template <int CI, int CN, int RO, int CO, typename Epi>
__device__ __forceinline__ void pair_conv(const bf16* in, int ldi,
                                          const bf16* __restrict__ w,
                                          Epi epi) {
  constexpr int NP = RO * (CO / 2);
  static_assert(CO % 2 == 0 && CI % 2 == 0 && CN % PO == 0, "pair_conv");
  for (int item = threadIdx.x; item < NP * (CN / PO); item += NT) {
    const int p = item % NP, o0 = (item / NP) * PO;
    const int r = p / (CO / 2), c = (p % (CO / 2)) * 2;
    float acc[2][PO];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int o = 0; o < PO; ++o) acc[q][o] = 0.f;
    for (int ky = 0; ky < 3; ++ky) {
      const bf16* row = in + ((r + ky) * (CO + 2) + c) * ldi;
#pragma unroll 2
      for (int ci = 0; ci < CI; ci += 2) {
        float2 xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xv[j] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(row + j * ldi + ci));
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const bf16* wt = w + ((size_t)(ky * 3 + kx) * CI + ci) * CN + o0;
          float w0[PO], w1[PO];
          bf16x8(__ldg(reinterpret_cast<const uint4*>(wt)), w0);
          bf16x8(__ldg(reinterpret_cast<const uint4*>(wt + CN)), w1);
#pragma unroll
          for (int o = 0; o < PO; ++o) {
            const float a0 = w0[o], a1 = w1[o];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              acc[q][o] = fmaf(xv[q + kx].x, a0, acc[q][o]);
              acc[q][o] = fmaf(xv[q + kx].y, a1, acc[q][o]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int o = 0; o < PO; ++o) epi(r, c + q, o0 + o, acc[q][o]);
  }
}

struct PairArgs {
  const bf16* x;            // [B, H, W, C]
  const float* ln_s;        // [C]
  const float* ln_b;
  const bf16* k1;           // [3, 3, C, C/3] HWIO
  const float* b1;          // [C/3]
  const bf16* k2;           // [3, 3, C/3, C]
  const float* b2;          // [C]
  bf16* out;                // [B, H, W, C]
  int H, W, plant;
};

template <int C>
__global__ void __launch_bounds__(NT) cab_pair_kernel(const PairArgs a) {
  constexpr int MID = C / 3;
  constexpr int LDL = ln_ld<C>(), LDM = ln_ld<MID>();
  constexpr int LH = PT_H + 4, LW = PT_W + 4;  // LN region (halo 2)
  constexpr int J = (C + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ln = reinterpret_cast<bf16*>(smem);   // [LH * LW, LDL]
  bf16* hid = ln + LH * LW * LDL;              // [(PT_H+2) * (PT_W+2), LDM]
  const int x0 = blockIdx.x * PT_W, y0 = blockIdx.y * PT_H, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // LN of the tile and its 2-pixel halo, zero outside the image
  for (int p = warp; p < LH * LW; p += NT / 32) {
    const int gy = y0 - 2 + p / LW, gx = x0 - 2 + p % LW;
    bf16* dst = ln + p * LDL;
    if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W) {
      for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* src = a.x + (((size_t)b * a.H + gy) * a.W + gx) * C;
    float v[J];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < C ? f(src[c]) : 0.f;
      sum += v[j];
      sq += v[j] * v[j];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / C;
    const float rs = rsqrtf(sq / C - mu * mu + kEps);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      if (c < C) dst[c] = __float2bfloat16((v[j] - mu) * rs * a.ln_s[c] + a.ln_b[c]);
    }
  }
  __syncthreads();
  // conv1 + bias + GELU over the tile and a 1-pixel halo, zero outside
  // the image (conv2's SAME padding)
  pair_conv<C, MID, PT_H + 2, PT_W + 2>(
      ln, LDL, a.k1, [&](int r, int c, int o, float acc) {
        const int gy = y0 - 1 + r, gx = x0 - 1 + c;
        const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        const float v = in || (a.plant & PLANT_HID_BORDER)
                            ? gelu_erf(acc + a.b1[o]) : 0.f;
        hid[(r * (PT_W + 2) + c) * LDM + o] = __float2bfloat16(v);
      });
  __syncthreads();
  // conv2 + bias into the output tile
  pair_conv<MID, C, PT_H, PT_W>(
      hid, LDM, a.k2, [&](int r, int c, int o, float acc) {
        const int gy = y0 + r;
        int gx = x0 + c;
        if (a.plant & PLANT_SWAP_PAIR) gx ^= 1;
        if (gy < a.H && gx < a.W)
          a.out[(((size_t)b * a.H + gy) * a.W + gx) * C + o] =
              __float2bfloat16(acc + a.b2[o]);
      });
}

template <int C>
int launch_pair(const PairArgs& a, int B, cudaStream_t s) {
  constexpr size_t bytes = pair_smem<C>();
  cudaError_t e = cudaFuncSetAttribute(
      cab_pair_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.W + PT_W - 1) / PT_W, (a.H + PT_H - 1) / PT_H, B);
  cab_pair_kernel<C><<<grid, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
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

// Kernel 8. w: the 13 weights in the order of ops/_build.HAB_WEIGHTS.
int hat_hab_block(const void* x, const void* cab, void* out, int nb, int C,
                  int nh, int n, int mlp, const void* const* w,
                  const void* ids, int nw_img, float scale, int c_real,
                  void* stream) {
  if (nb < 1 || (ids && (nw_img <= 0 || nb % nw_img)) || c_real < 1 ||
      c_real > C)
    return (int)cudaErrorInvalidValue;
  HabArgs a = hab_args(x, cab, out, w, scale, c_real);
  a.ids = static_cast<const int*>(ids);
  a.nw_img = nw_img;
  return dispatch_hab<false>(a, nb, C, nh, n, mlp,
                             static_cast<cudaStream_t>(stream));
}

// Kernel 11 on the maps x, cab_y, out [B, H, W, C] and se [B, C] f32;
// window ws (n = ws * ws), shift 0 or ws / 2.
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

// Kernel 12 on x, out [B, H, W, C], C 96 or 120.
int hat_cab_pair(const void* x, int B, int H, int W, int C, const void* ln_s,
                 const void* ln_b, const void* k1, const void* b1,
                 const void* k2, const void* b2, void* out, int plant,
                 void* stream) {
  if (B < 1 || H < 1 || W < 2 || W % 2) return (int)cudaErrorInvalidValue;
  PairArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.k1 = static_cast<const bf16*>(k1);
  a.b1 = static_cast<const float*>(b1);
  a.k2 = static_cast<const bf16*>(k2);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.W = W;
  a.plant = plant;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 96) return launch_pair<96>(a, B, s);
  if (C == 120) return launch_pair<120>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
