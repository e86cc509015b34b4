// Hand-written CUDA kernels of the HAT stage of the hybrid RRDBNet -> HAT
// deploy path (sm_90a).
//
//   7 fused_cab_convs  (replaces superresolution_tpu/ops/pallas_hab.py:
//      fused_cab_convs / _cab_kernel): layernorm_kernel writes LN(x) in
//      bf16 (f32 statistics over C), then two launches of the shared
//      conv3x3_kernel of sr_kernels.cu: conv C->C/3 + bias + exact GELU
//      into a [B,H,W,C/3] workspace, conv C/3->C + bias. Each conv reads
//      its input through a zero halo, so conv1 sees 0 outside the image,
//      not LN(0) = ln bias, and conv2 sees 0, not GELU(bias): the trap the
//      Pallas kernel masks by hand (_cab_kernel's mask(ln, 0)).
//   8 fused_hab_block  (replaces ops/pallas_hab.py: fused_hab_block /
//      fused_hab_block_inference, _fused_fwd_impl / _kernel / _body):
//      hab_kernel, one thread block per window. LN1 -> qkv -> per head
//      softmax(q k^T hd^-1/2 + rpb[h] (+ -1e9 where region ids differ)) v
//      -> proj -> x1 = x + proj + cab -> LN2 -> fc1 -> exact GELU -> fc2 ->
//      x1 + o, with every intermediate in shared memory and the weights
//      read through L1/L2. Templated on (C, heads, tokens n, MLP hidden),
//      instantiated for (96, 6, 64, 192), (96, 6, 256, 192) and (120, 6,
//      256, 240): 8x8 and 16x16 windows, head dim 16 and 20.
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
// (4-byte aligned at every head dim here).
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
// FLOP/B, and more at n 256; the CAB 55,296 MACs per pixel for 384 bytes
// at C 96, 288 FLOP/B. Both sit at or near the ridge, so a fast form
// needs both the tensor cores and one pass over memory. This first form
// runs every product on the CUDA cores in f32 FMA (67 TFLOP/s peak), so
// it can reach at most ~7% of the operation bound; it does keep the one
// pass: the HAB reads each activation once and writes each output once,
// and the CAB writes only LN(x) and its hidden map besides.

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
    layernorm_kernel(const bf16* __restrict__ x, int rows, int C,
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
  const float mu = sum / C;
  const float rs = rsqrtf(sq / C - mu * mu + kEps);
  for (int c = lane; c < C; c += 32)
    out[(size_t)row * C + c] =
        __float2bfloat16((f(xr[c]) - mu) * rs * s[c] + b[c]);
}

// ---- pieces of kernel 8 (blockDim.x == NT) ----------------------------

// LN of `rows` rows of a [*, C] smem tile (row stride lda) into another,
// one warp per row; columns past C masked.
template <int C>
__device__ void ln_rows(const bf16* in, bf16* out, int lda, int rows,
                        const float* __restrict__ s,
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
    const float mu = sum / C;
    const float rs = rsqrtf(sq / C - mu * mu + kEps);
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

// Copy a contiguous [rows, C] bf16 block into a padded smem tile.
template <int C>
__device__ __forceinline__ void load_tile(bf16* dst, int lda, const bf16* src,
                                          int rows) {
  static_assert(C % 8 == 0, "16-byte rows");
  for (int e = threadIdx.x; e < rows * (C / 8); e += NT) {
    const int r = e / (C / 8), c8 = e % (C / 8);
    *reinterpret_cast<uint4*>(dst + r * lda + c8 * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * C + c8 * 8);
  }
}

// ---- kernel 8: the HAB block body, one block per window ----------------
struct HabArgs {
  const bf16* x;            // [nb, n, C] windows
  const bf16* cab;          // [nb, n, C], conv_scale already applied
  bf16* out;                // [nb, n, C]
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
  const int* ids;           // [nw_img, n] region ids, or null
  int nw_img;
  float scale;              // head_dim ** -0.5
};

template <int C, int N, int MLP>
constexpr size_t hab_smem() {
  return (size_t)(2 * N * (C + 8) + 3 * RT * (C + 8) + RT * (MLP + 8)) *
             sizeof(bf16) +
         N * sizeof(int);
}

template <int C, int NH, int N, int MLP>
__global__ void __launch_bounds__(NT) hab_kernel(const HabArgs a) {
  constexpr int LDA = C + 8;      // smem row stride (bf16) of [*, C] tiles
  constexpr int LDH = MLP + 8;    // smem row stride of the MLP hidden tile
  constexpr int HD = C / NH;
  static_assert(N % RT == 0 && C % NH == 0, "geometry");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [N, LDA] keys of the window
  bf16* vs = ks + N * LDA;                   // [N, LDA] values
  bf16* xs = vs + N * LDA;   // [RT, LDA] x of the tile, then x1
  bf16* ys = xs + RT * LDA;  // LN1(x), then attention out, then LN2(x1)
  bf16* qs = ys + RT * LDA;  // q
  bf16* hs = qs + RT * LDA;  // [RT, LDH] MLP hidden
  int* ids = reinterpret_cast<int*>(hs + RT * LDH);
  const size_t base = (size_t)blockIdx.x * N * C;
  const bool masked = a.ids != nullptr;

  if (masked)
    for (int t = threadIdx.x; t < N; t += NT)
      ids[t] = a.ids[(size_t)(blockIdx.x % a.nw_img) * N + t];
  // k and v of every token of the window
  for (int t0 = 0; t0 < N; t0 += RT) {
    load_tile<C>(xs, LDA, a.x + base + (size_t)t0 * C, RT);
    __syncthreads();
    ln_rows<C>(xs, ys, LDA, RT, a.ln1_s, a.ln1_b);
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
    load_tile<C>(xs, LDA, a.x + base + (size_t)t0 * C, RT);
    __syncthreads();
    ln_rows<C>(xs, ys, LDA, RT, a.ln1_s, a.ln1_b);
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
      xs[r * LDA + c] = __float2bfloat16(
          t + f(a.cab[base + (size_t)(t0 + r) * C + c]));
    });
    __syncthreads();
    ln_rows<C>(xs, ys, LDA, RT, a.ln2_s, a.ln2_b);
    __syncthreads();
    gemm_rows<C, MLP, MLP>(ys, LDA, a.w1, [&](int r, int c, float acc) {
      hs[r * LDH + c] = __float2bfloat16(gelu_erf(acc + a.b1[c]));
    });
    __syncthreads();
    gemm_rows<MLP, C, C>(hs, LDH, a.w2, [&](int r, int c, float acc) {
      a.out[base + (size_t)(t0 + r) * C + c] =
          __float2bfloat16(f(xs[r * LDA + c]) + rbf(acc + a.b2[c]));
    });
    __syncthreads();  // before the next tile overwrites xs and hs
  }
}

template <int C, int NH, int N, int MLP>
int launch_hab(const HabArgs& a, int nb, cudaStream_t stream) {
  constexpr size_t bytes = hab_smem<C, N, MLP>();
  cudaError_t e = cudaFuncSetAttribute(
      hab_kernel<C, NH, N, MLP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  hab_kernel<C, NH, N, MLP><<<nb, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All return the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a shape the kernels do not take.

int hat_layernorm(const void* x, int rows, int C, const void* s,
                  const void* b, void* out, void* stream) {
  const unsigned blocks = (unsigned)((rows + LN_THREADS / 32 - 1) /
                                     (LN_THREADS / 32));
  layernorm_kernel<<<blocks, LN_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), rows, C, static_cast<const float*>(s),
      static_cast<const float*>(b), static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

int hat_hab_block(const void* x, const void* cab, void* out, int nb, int C,
                  int nh, int n, int mlp, const void* ln1_s,
                  const void* ln1_b, const void* wqkv, const void* bqkv,
                  const void* rpb, const void* wp, const void* bp,
                  const void* ln2_s, const void* ln2_b, const void* w1,
                  const void* b1, const void* w2, const void* b2,
                  const void* ids, int nw_img, float scale, void* stream) {
  if (nb < 1 || (ids && (nw_img <= 0 || nb % nw_img)))
    return (int)cudaErrorInvalidValue;
  HabArgs a;
  a.x = static_cast<const bf16*>(x);
  a.cab = static_cast<const bf16*>(cab);
  a.out = static_cast<bf16*>(out);
  a.ln1_s = static_cast<const float*>(ln1_s);
  a.ln1_b = static_cast<const float*>(ln1_b);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.rpb = static_cast<const float*>(rpb);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.ln2_s = static_cast<const float*>(ln2_s);
  a.ln2_b = static_cast<const float*>(ln2_b);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.ids = static_cast<const int*>(ids);
  a.nw_img = nw_img;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 96 && nh == 6 && n == 64 && mlp == 192)
    return launch_hab<96, 6, 64, 192>(a, nb, s);
  if (C == 96 && nh == 6 && n == 256 && mlp == 192)
    return launch_hab<96, 6, 256, 192>(a, nb, s);
  if (C == 120 && nh == 6 && n == 256 && mlp == 240)
    return launch_hab<120, 6, 256, 240>(a, nb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
