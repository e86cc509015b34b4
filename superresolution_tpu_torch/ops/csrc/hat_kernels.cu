// Hand-written CUDA kernels of the hybrid RRDBNet -> HAT x4 deploy path's
// HAT stage (sm_90a), at the configuration it runs: C = 96 channels, 6
// heads of 16, 8x8 windows (n = 64 tokens), MLP hidden 192, OCAB key
// windows of 12x12.
//
//   7 fused_cab_convs  (replaces superresolution_tpu/ops/pallas_hab.py:
//      fused_cab_convs / _cab_kernel): layernorm_kernel writes LN(x) in
//      bf16 (f32 statistics over C), then two launches of the shared
//      conv3x3_kernel of sr_kernels.cu: conv 96->32 + bias + exact GELU
//      into a [B,H,W,32] workspace, conv 32->96 + bias. Each conv reads
//      its input through a zero halo, so conv1 sees 0 outside the image,
//      not LN(0) = ln bias, and conv2 sees 0, not GELU(bias): the trap the
//      Pallas kernel masks by hand (_cab_kernel's mask(ln, 0)).
//   8 fused_hab_block  (replaces ops/pallas_hab.py: fused_hab_block /
//      fused_hab_block_inference, _fused_fwd_impl / _kernel / _body):
//      hab_kernel, one thread block per window. LN1 -> qkv -> per head
//      softmax(q k^T / 4 + rpb[h] (+ -1e9 where region ids differ)) v ->
//      proj -> x1 = x + proj + cab -> LN2 -> fc1 -> exact GELU -> fc2 ->
//      x1 + o, with every intermediate in shared memory and the weights
//      read through L1/L2.
//   9 flash_oca_gathered  (replaces ops/pallas_flash_oca.py:
//      flash_oca_gathered / _fwd_impl / _kernel): oca_kernel, one thread
//      block per query window; it copies its 12x12 key and value patch
//      straight from the zero-padded maps into shared memory, so the
//      gathered [nb, 144, C] tensor is never written. The padded keys
//      are zero vectors whose logits are the bias alone; they take part
//      in the softmax, as in the reference.
//
// Rounding follows the reference: f32 accumulation and f32 softmax; bf16
// stores of LN outputs, q, k, v, the probabilities, the attention output,
// proj, x1, the MLP hidden and o. The -1e9 mask underflows to exactly 0
// in expf.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s; ridge ~295 FLOP/B):
// the HAB does 86,016 MACs per token for 576 bytes (x, cab, out), 299
// FLOP/B; the CAB 55,296 MACs per pixel for 384 bytes, 288 FLOP/B; the
// OCA 27,648 MACs per query token for 384 bytes plus the two maps, bound
// by bytes. All three sit at or near the ridge, so a fast form needs both
// the tensor cores and one pass over memory. This first form runs every
// product on the CUDA cores in f32 FMA (67 TFLOP/s peak), so it can reach
// at most ~7% of the operation bound; it does keep the one pass: the HAB
// and OCA read each activation once and write each output once, and the
// CAB writes only LN(x) and its 32-channel hidden map besides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-5f;
constexpr float kNeg = -1e9f;

constexpr int HC = 96;          // channels
constexpr int HNH = 6;          // heads
constexpr int HHD = HC / HNH;   // head dim, 16
constexpr int HN = 64;          // tokens per window (8x8)
constexpr int HMLP = 192;       // HAB MLP hidden
constexpr int OWS = 12;         // OCAB key window side
constexpr int OM = OWS * OWS;   // keys per OCAB window, 144
constexpr int WS = 8;           // window side
constexpr int NT = 256;         // threads per block
constexpr int LDA = HC + 8;     // smem row stride (bf16) of [*, HC] tiles
constexpr int LDH = HMLP + 8;   // smem row stride of the MLP hidden tile

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

// ---- pieces of the window kernels (blockDim.x == NT) -------------------

// LN of a [HN, HC] smem tile into another, one warp per row.
__device__ void ln_tile(const bf16* in, bf16* out,
                        const float* __restrict__ s,
                        const float* __restrict__ b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < HN; r += NT / 32) {
    float v[HC / 32];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < HC / 32; ++j) {
      v[j] = f(in[r * LDA + lane + 32 * j]);
      sum += v[j];
      sq += v[j] * v[j];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / HC;
    const float rs = rsqrtf(sq / HC - mu * mu + kEps);
#pragma unroll
    for (int j = 0; j < HC / 32; ++j) {
      const int c = lane + 32 * j;
      out[r * LDA + c] = __float2bfloat16((v[j] - mu) * rs * s[c] + b[c]);
    }
  }
}

// [HN, K] (smem, row stride lda) @ [K, N] (global, row stride LDW) with
// f32 accumulation. Warp w owns rows 8w..8w+7 and lane l the columns l + 32j,
// so a warp reads 32 consecutive weights per row of W and one broadcast A
// value per row. epi(row, col, acc) sees every output once.
template <int K, int N, int LDW, typename Epi>
__device__ __forceinline__ void gemm_rows(const bf16* A, int lda,
                                          const bf16* __restrict__ W,
                                          Epi epi) {
  constexpr int RM = HN / (NT / 32);
  constexpr int NJ = N / 32;
  static_assert(N % 32 == 0 && K % 2 == 0, "gemm_rows shape");
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
      const float w0 = f(W[k * LDW + lane + 32 * j]);
      const float w1 = f(W[(k + 1) * LDW + lane + 32 * j]);
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
    for (int j = 0; j < NJ; ++j) epi(r0 + r, lane + 32 * j, acc[r][j]);
}

// One head of softmax attention for the block's HN queries over M keys.
// Query row i = tid / 4 is held by four lanes; lane g = tid % 4 takes the
// keys g, g + 4, ... (consecutive rows of the padded ks/vs tiles fall in
// distinct banks). Logits and softmax in f32, probabilities rounded to
// bf16, their sum with v in f32; the four partial outputs are summed
// across the lanes and lane g stores head dims 4g..4g+3 via store(d, v).
template <int M, typename Bias, typename Store>
__device__ __forceinline__ void attend(const bf16* qs, const bf16* ks,
                                       const bf16* vs, int c0, float scale,
                                       Bias bias, Store store) {
  constexpr int JJ = M / 4;
  const int i = threadIdx.x >> 2, g = threadIdx.x & 3;
  float q[HHD];
#pragma unroll
  for (int d = 0; d < HHD; d += 2) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(qs + i * LDA + c0 + d));
    q[d] = t.x;
    q[d + 1] = t.y;
  }
  float s[JJ];
  float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int jj = 0; jj < JJ; ++jj) {
    const int j = g + 4 * jj;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HHD; d += 2) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ks + j * LDA + c0 + d));
      acc = fmaf(q[d], t.x, acc);
      acc = fmaf(q[d + 1], t.y, acc);
    }
    s[jj] = acc * scale + bias(i, j);
    m = fmaxf(m, s[jj]);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < JJ; ++jj) {
    s[jj] = expf(s[jj] - m);
    sum += s[jj];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  float o[HHD];
#pragma unroll
  for (int d = 0; d < HHD; ++d) o[d] = 0.f;
#pragma unroll
  for (int jj = 0; jj < JJ; ++jj) {
    const int j = g + 4 * jj;
    const float p = rbf(s[jj] / sum);
#pragma unroll
    for (int d = 0; d < HHD; d += 2) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vs + j * LDA + c0 + d));
      o[d] = fmaf(p, t.x, o[d]);
      o[d + 1] = fmaf(p, t.y, o[d + 1]);
    }
  }
#pragma unroll
  for (int d = 0; d < HHD; ++d) {
    o[d] += __shfl_xor_sync(0xffffffffu, o[d], 1);
    o[d] += __shfl_xor_sync(0xffffffffu, o[d], 2);
  }
#pragma unroll
  for (int d = 0; d < HHD; ++d)
    if ((d >> 2) == g) store(i, c0 + d, o[d]);
}

// Copy a contiguous [rows, HC] bf16 block into a padded smem tile.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows) {
  for (int e = threadIdx.x; e < rows * (HC / 8); e += NT) {
    const int r = e / (HC / 8), c8 = e % (HC / 8);
    *reinterpret_cast<uint4*>(dst + r * LDA + c8 * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * HC + c8 * 8);
  }
}

// ---- kernel 8: the HAB block body, one block per window ----------------
struct HabArgs {
  const bf16* x;            // [nb, HN, HC] windows
  const bf16* cab;          // [nb, HN, HC], conv_scale already applied
  bf16* out;                // [nb, HN, HC]
  const float* ln1_s;       // [HC]
  const float* ln1_b;
  const bf16* wqkv;         // [HC, 3 HC], columns q | k | v
  const float* bqkv;        // [3 HC]
  const float* rpb;         // [HNH, HN, HN]
  const bf16* wp;           // [HC, HC]
  const float* bp;
  const float* ln2_s;
  const float* ln2_b;
  const bf16* w1;           // [HC, HMLP]
  const float* b1;
  const bf16* w2;           // [HMLP, HC]
  const float* b2;
  const int* ids;           // [nw_img, HN] region ids, or null
  int nw_img;
  float scale;              // head_dim ** -0.5
};

constexpr size_t HAB_SMEM = 5 * HN * LDA * sizeof(bf16) + HN * sizeof(int);

__global__ void __launch_bounds__(NT, 2) hab_kernel(const HabArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // x, then x1
  bf16* ys = xs + HN * LDA;  // LN1(x), then attention out, then LN2(x1)
  bf16* qs = ys + HN * LDA;
  bf16* ks = qs + HN * LDA;
  bf16* vs = ks + HN * LDA;
  bf16* hs = qs;  // MLP hidden [HN, LDH], over the dead q and k tiles
  int* ids = reinterpret_cast<int*>(vs + HN * LDA);
  const size_t base = (size_t)blockIdx.x * HN * HC;
  const bool masked = a.ids != nullptr;

  load_tile(xs, a.x + base, HN);
  if (masked && threadIdx.x < HN)
    ids[threadIdx.x] =
        a.ids[(size_t)(blockIdx.x % a.nw_img) * HN + threadIdx.x];
  __syncthreads();
  ln_tile(xs, ys, a.ln1_s, a.ln1_b);
  __syncthreads();
  // q, k and v as three column slices of wqkv (24 accumulators a thread)
  bf16* qkv[3] = {qs, ks, vs};
#pragma unroll
  for (int p = 0; p < 3; ++p)
    gemm_rows<HC, HC, 3 * HC>(ys, LDA, a.wqkv + p * HC,
                              [&](int r, int c, float acc) {
      qkv[p][r * LDA + c] = __float2bfloat16(acc + a.bqkv[p * HC + c]);
    });
  __syncthreads();
  for (int h = 0; h < HNH; ++h)
    attend<HN>(
        qs, ks, vs, h * HHD, a.scale,
        [&](int i, int j) {
          const float v = a.rpb[(h * HN + i) * HN + j];
          return masked && ids[i] != ids[j] ? v + kNeg : v;
        },
        [&](int i, int c, float v) {
          ys[i * LDA + c] = __float2bfloat16(v);
        });
  __syncthreads();
  gemm_rows<HC, HC, HC>(ys, LDA, a.wp, [&](int r, int c, float acc) {
    const float t = rbf(f(xs[r * LDA + c]) + rbf(acc + a.bp[c]));
    xs[r * LDA + c] = __float2bfloat16(t + f(a.cab[base + r * HC + c]));
  });
  __syncthreads();
  ln_tile(xs, ys, a.ln2_s, a.ln2_b);
  __syncthreads();
  gemm_rows<HC, HMLP, HMLP>(ys, LDA, a.w1, [&](int r, int c, float acc) {
    hs[r * LDH + c] = __float2bfloat16(gelu_erf(acc + a.b1[c]));
  });
  __syncthreads();
  gemm_rows<HMLP, HC, HC>(hs, LDH, a.w2, [&](int r, int c, float acc) {
    a.out[base + r * HC + c] =
        __float2bfloat16(f(xs[r * LDA + c]) + rbf(acc + a.b2[c]));
  });
}

// ---- kernel 9: OCAB attention with the kv gather in the kernel ---------
struct OcaArgs {
  const bf16* q;     // [B * nh_w * nw_w, HN, HC]
  const bf16* kmap;  // [B, hp, wp, HC], zero-padded by (OWS - WS) / 2
  const bf16* vmap;
  const float* bias; // [HNH, HN, OM]
  bf16* out;         // [B * nh_w * nw_w, HN, HC]
  int nh_w, nw_w, hp, wp;
  float scale;
};

constexpr size_t OCA_SMEM = (HN + 2 * OM) * LDA * sizeof(bf16);

__global__ void __launch_bounds__(NT) oca_kernel(const OcaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + HN * LDA;
  bf16* vs = ks + OM * LDA;
  const int wi = blockIdx.x;
  const int wc = wi % a.nw_w;
  const int wr = (wi / a.nw_w) % a.nh_w;
  const int b = wi / (a.nw_w * a.nh_w);
  const size_t base = (size_t)wi * HN * HC;

  load_tile(qs, a.q + base, HN);
  for (int e = threadIdx.x; e < OM * (HC / 8); e += NT) {
    const int t = e / (HC / 8), c8 = e % (HC / 8);
    const size_t pix =
        ((size_t)b * a.hp + wr * WS + t / OWS) * a.wp + wc * WS + t % OWS;
    *reinterpret_cast<uint4*>(ks + t * LDA + c8 * 8) =
        *reinterpret_cast<const uint4*>(a.kmap + pix * HC + c8 * 8);
    *reinterpret_cast<uint4*>(vs + t * LDA + c8 * 8) =
        *reinterpret_cast<const uint4*>(a.vmap + pix * HC + c8 * 8);
  }
  __syncthreads();
  for (int h = 0; h < HNH; ++h)
    attend<OM>(
        qs, ks, vs, h * HHD, a.scale,
        [&](int i, int j) { return a.bias[(h * HN + i) * OM + j]; },
        [&](int i, int c, float v) {
          a.out[base + i * HC + c] = __float2bfloat16(v);
        });
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
  if (C != HC || nh != HNH || n != HN || mlp != HMLP ||
      (ids && (nw_img <= 0 || nb % nw_img)))
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
  cudaError_t e = cudaFuncSetAttribute(
      hab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HAB_SMEM);
  if (e != cudaSuccess) return (int)e;
  hab_kernel<<<nb, NT, HAB_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int hat_oca(const void* q, const void* kmap, const void* vmap,
            const void* bias, void* out, int B, int nh_w, int nw_w, int hp,
            int wp, int C, int nh, int ws, int ows, float scale,
            void* stream) {
  if (C != HC || nh != HNH || ws != WS || ows != OWS ||
      hp < nh_w * WS + OWS - WS || wp < nw_w * WS + OWS - WS)
    return (int)cudaErrorInvalidValue;
  OcaArgs a;
  a.q = static_cast<const bf16*>(q);
  a.kmap = static_cast<const bf16*>(kmap);
  a.vmap = static_cast<const bf16*>(vmap);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.nh_w = nh_w;
  a.nw_w = nw_w;
  a.hp = hp;
  a.wp = wp;
  a.scale = scale;
  cudaError_t e = cudaFuncSetAttribute(
      oca_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, OCA_SMEM);
  if (e != cudaSuccess) return (int)e;
  oca_kernel<<<B * nh_w * nw_w, NT, OCA_SMEM,
               static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
