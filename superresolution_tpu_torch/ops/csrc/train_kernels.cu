// Hand-written CUDA kernels of the hybrid_astro training step (sm_90a).
//
//   Kernel 13, the dense block's backward (replaces superresolution_tpu/
//   ops/pallas_dense_trunk_vjp.py:fused_dense_block_train, _bwd_kernel).
//   ops/dense_trunk_train.py runs it as a fixed sequence of launches:
//     - B1's first four convs recompute y_1..y_4 (B1's route);
//     - dense_scale_kernel writes dacc5 = bf16(s_acc * dout) into the
//       cotangent workspace D = [dacc5 | dpre4 | dpre3 | dpre2 | dpre1];
//     - four transposed convs, one per source y_4..y_1, each a SAME 3x3
//       conv over a prefix of D with flipped, channel-transposed weights
//       and an lrelu' gate epilogue, write dpre_i = bf16(lrelu'(y_i) * sum
//       of every later conv's cotangent);
//     - one more over all of D gives dx = convT + s_id * dout;
//     - per conv, the weight grad: per pixel chunk, f32 partials of
//       dW_j[tap][ci][co] = sum_p in_j[p + tap] * dpre_j[p] (and of db_j =
//       sum_p dpre_j[p]); wgrad_reduce_kernel sums the chunks in a fixed
//       order and casts dW to the weight's type. No float atomics: two
//       runs give the same bits.
//   The route rule (ops/dense_trunk.uses_tensor_cores) sends the models'
//   shapes to the tensor cores: the transposed convs, the weight grads
//   and the flipped weights are train_tc_kernels.cu's. This file keeps
//   dense_scale_kernel, wgrad_reduce_kernel, and the f32 FFMA forms that
//   other shapes take: the transposed convs through sr_kernels.cu's
//   conv3x3_kernel and wgrad_kernel below. f32 activations (a model
//   trained under precision "fp32") run the transposed convs on the conv
//   engine's direct body (train_tc_kernels.cu DenseGradConv<float>), and
//   wgrad_kernel, wgrad_reduce_kernel and dense_scale_kernel in f32.
//     With `seg` (batch-packed rows, see sr_kernels.cu's B1) every conv
//     launch above reads spacer rows as zero and writes them as 0, and
//     the weight grads read them as zero in both staged inputs, so dx
//     and every cotangent are exactly 0 there (pallas_dense_trunk_vjp.py
//     _mask_flat) and no spacer row enters dW or db.
//   Kernel 14, the star-weighted L1 (replaces ops/pallas_loss.py:
//   star_weighted_l1_pallas): star_l1_fwd_kernel, one launch, reduces
//   |p - t| * (t > thr ? w : 1) over float4 chunks into per-block f32
//   partials, and the last block to finish sums them in block order and
//   divides by n; star_l1_bwd_kernel writes sign(p - t) * w(t) * g / n
//   over float4 chunks, reading the upstream gradient g from device
//   memory (no host sync).
//
// Bounds on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s). Kernel 13 at
// [4,128,128,64], c 64, g 32: dgrad and wgrad each do the forward's
// 239,616 MACs per pixel and the recompute (convs 1-4) 129,024, so
// 608,256 in all, 8.0e10 FLOP a call against ~60 MB of x, dout, dx and
// the weights: bound by operations (0.081 ms).
// Kernel 14 does 4-5 operations per 8-12 bytes: bound by bytes.
//
// The direct forms accumulate in f32 on the CUDA cores (FFMA, 67
// TFLOP/s), so they reach at most ~7% of kernel 13's bound; the wgrad
// re-stages the input tile from device memory for each of its channel
// tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG_TH = 8;        // pixel tile rows
constexpr int WG_TW = 16;       // pixel tile columns
constexpr int WG_CI = 16;       // input channels per block
constexpr int WG_CO = 32;       // output channels per block (8 quads)
constexpr int WG_THREADS = 256; // 2 row halves x 16 ci x 8 co quads
constexpr int WG_ACC = 9 * 4;   // accumulators per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// T: bf16, or f32 for a model trained under precision "fp32".
template <typename T>
struct WgradArgs {
  // in_j = [in0 channels 0..cin0) | in1 channels 0..cin1)], NHWC.
  const T* in0;
  int in0_stride, cin0;
  const T* in1;
  int in1_stride, cin1;
  const T* d;              // dpre_j: channel o at d[pix * d_stride + o]
  int d_stride, cout;
  int B, H, W;
  int seg_stride, seg_valid;  // batch-packed rows, as sr_kernels.cu's
                              // ConvArgs: spacer rows of in_j and of
                              // dpre_j read as zero (seg_stride 0: none)
  float* part_w;           // [nchunk][9][cin][cout]
  float* part_b;           // [nchunk][cout], or null
  int nchunk;
};

template <typename T>
__device__ __forceinline__ bool image_row(const WgradArgs<T>& a, int y) {
  return a.seg_stride == 0 || y % a.seg_stride < a.seg_valid;
}

// Grid (nchunk, ci tiles, co tiles). Block `chunk` walks pixel tiles
// chunk, chunk + nchunk, ...; each tile stages in_j with a 1-pixel zero
// halo (WG_CI channels) and dpre_j (WG_CO channels) in shared memory as
// f32. A thread owns one input channel, four output channels and all 9
// taps, over half the tile's rows; the halves are summed at the end.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS)
    wgrad_kernel(const WgradArgs<T> a) {
  __shared__ float in_s[WG_CI][WG_TH + 2][WG_TW + 2];
  __shared__ __align__(16) float d_s[WG_TH][WG_TW][WG_CO];
  __shared__ float red_s[WG_THREADS / 2][WG_ACC + 4];

  const int tid = threadIdx.x;
  const int half = tid / (WG_THREADS / 2);
  const int r = tid % (WG_THREADS / 2);
  const int ci_l = r / 8;
  const int cq = r % 8;
  const int cin = a.cin0 + a.cin1;
  const int ci0 = blockIdx.y * WG_CI;
  const int co0 = blockIdx.z * WG_CO;
  const bool do_bias = a.part_b != nullptr && blockIdx.y == 0 && ci_l == 0;
  const int tiles_y = (a.H + WG_TH - 1) / WG_TH;
  const int tiles_x = (a.W + WG_TW - 1) / WG_TW;
  const int ntiles = a.B * tiles_y * tiles_x;

  float acc[WG_ACC];
#pragma unroll
  for (int k = 0; k < WG_ACC; ++k) acc[k] = 0.f;
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int t = blockIdx.x; t < ntiles; t += a.nchunk) {
    const int b = t / (tiles_y * tiles_x);
    const int y0 = ((t / tiles_x) % tiles_y) * WG_TH;
    const int x0 = (t % tiles_x) * WG_TW;
    for (int e = tid; e < WG_CI * (WG_TH + 2) * (WG_TW + 2);
         e += WG_THREADS) {
      const int ci = e % WG_CI;
      const int pix = e / WG_CI;
      const int px = pix % (WG_TW + 2);
      const int py = pix / (WG_TW + 2);
      const int gy = y0 + py - 1;
      const int gx = x0 + px - 1;
      const int c = ci0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < cin &&
          image_row(a, gy)) {
        const size_t p = ((size_t)b * a.H + gy) * a.W + gx;
        v = to_f(c < a.cin0 ? a.in0[p * a.in0_stride + c]
                            : a.in1[p * a.in1_stride + c - a.cin0]);
      }
      in_s[ci][py][px] = v;
    }
    for (int e = tid; e < WG_TH * WG_TW * WG_CO; e += WG_THREADS) {
      const int co = e % WG_CO;
      const int pix = e / WG_CO;
      const int px = pix % WG_TW;
      const int py = pix / WG_TW;
      const int gy = y0 + py;
      const int gx = x0 + px;
      const int o = co0 + co;
      float v = 0.f;
      if (gy < a.H && gx < a.W && o < a.cout && image_row(a, gy))
        v = to_f(a.d[(((size_t)b * a.H + gy) * a.W + gx) * a.d_stride + o]);
      d_s[py][px][co] = v;
    }
    __syncthreads();
    for (int py = half * (WG_TH / 2); py < (half + 1) * (WG_TH / 2); ++py) {
#pragma unroll 2
      for (int px = 0; px < WG_TW; ++px) {
        const float4 dv = *reinterpret_cast<const float4*>(&d_s[py][px][cq * 4]);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float iv = in_s[ci_l][py + dy][px + dx];
            float* ac = &acc[(dy * 3 + dx) * 4];
            ac[0] = fmaf(iv, dv.x, ac[0]);
            ac[1] = fmaf(iv, dv.y, ac[1]);
            ac[2] = fmaf(iv, dv.z, ac[2]);
            ac[3] = fmaf(iv, dv.w, ac[3]);
          }
        }
        if (do_bias) {
          bacc[0] += dv.x;
          bacc[1] += dv.y;
          bacc[2] += dv.z;
          bacc[3] += dv.w;
        }
      }
    }
    __syncthreads();
  }

  if (half == 1) {
#pragma unroll
    for (int k = 0; k < WG_ACC; ++k) red_s[r][k] = acc[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) red_s[r][WG_ACC + k] = bacc[k];
  }
  __syncthreads();
  if (half == 1) return;
  const int ci = ci0 + ci_l;
  const size_t nw = (size_t)9 * cin * a.cout;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int o = co0 + cq * 4 + k;
    if (o >= a.cout) break;
    if (ci < cin) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        a.part_w[(size_t)blockIdx.x * nw + ((size_t)tap * cin + ci) * a.cout +
                 o] = acc[tap * 4 + k] + red_s[r][tap * 4 + k];
    }
    if (do_bias)
      a.part_b[(size_t)blockIdx.x * a.cout + o] =
          bacc[k] + red_s[r][WG_ACC + k];
  }
}

constexpr int RED_THREADS = 256;

// dW[i] = sum over chunks k = 0..nchunk-1, in that order, of
// part_w[k][i], cast to dW's type T; db likewise, kept in f32.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
    wgrad_reduce_kernel(const float* __restrict__ part_w, size_t nw,
                        const float* __restrict__ part_b, int cout, int nchunk,
                        T* __restrict__ dw, float* __restrict__ db) {
  const size_t i = (size_t)blockIdx.x * RED_THREADS + threadIdx.x;
  if (i < nw) {
    float s = 0.f;
    for (int k = 0; k < nchunk; ++k) s += part_w[(size_t)k * nw + i];
    store(dw + i, s);
  }
  if (part_b != nullptr && i < (size_t)cout) {
    float s = 0.f;
    for (int k = 0; k < nchunk; ++k) s += part_b[(size_t)k * cout + i];
    db[i] = s;
  }
}

constexpr int EW_THREADS = 256;

// out[p * out_stride + o] = T(scale * in[p * c + o]) for o < c.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
    dense_scale_kernel(const T* __restrict__ in, size_t npix, int c,
                       float scale, T* __restrict__ out, int out_stride) {
  const size_t n = npix * c;
  for (size_t i = (size_t)blockIdx.x * EW_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * EW_THREADS) {
    const size_t p = i / c;
    store(out + p * out_stride + i % c, scale * to_f(in[i]));
  }
}

constexpr int SL_THREADS = 256;

__device__ __forceinline__ float block_sum(float v, float* warp_s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) warp_s[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int k = 0; k < (int)(blockDim.x / 32); ++k) s += warp_s[k];
  return s;  // valid in thread 0
}

// The star-weighted term of one element, without FMA contraction (so a
// plain model in f32 can repeat the sums bit for bit).
__device__ __forceinline__ float star_term(float p, float t, float thr,
                                           float w) {
  const float d = fabsf(p - t);
  return t > thr ? __fmul_rn(d, w) : d;
}

// The forward's ticket: 0 between launches (each launch leaves it 0), so
// forwards on one device run on one stream at a time.
__device__ unsigned star_l1_ticket = 0u;

// Kernel 14's forward in one launch: each thread sums the terms of its
// float4 chunks (grid-stride; the n % 4 tail in block 0), each block
// reduces its threads into part[block]; the last block to finish (an
// atomic ticket behind a __threadfence) sums the partials in block order,
// writes out[0] = sum / n and resets the ticket for the next launch. The
// grid, and so every sum's order, depends on n alone: two runs give the
// same bits.
__global__ void __launch_bounds__(SL_THREADS)
    star_l1_fwd_kernel(const float* __restrict__ p,
                       const float* __restrict__ t, size_t n, float thr,
                       float w, float* part, float* __restrict__ out) {
  __shared__ float warp_s[SL_THREADS / 32];
  __shared__ bool last;
  const size_t n4 = n / 4;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* t4 = reinterpret_cast<const float4*>(t);
  float s = 0.f;
  for (size_t i = (size_t)blockIdx.x * SL_THREADS + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * SL_THREADS) {
    const float4 pv = __ldg(p4 + i), tv = __ldg(t4 + i);
    s += star_term(pv.x, tv.x, thr, w);
    s += star_term(pv.y, tv.y, thr, w);
    s += star_term(pv.z, tv.z, thr, w);
    s += star_term(pv.w, tv.w, thr, w);
  }
  if (blockIdx.x == 0 && 4 * n4 + threadIdx.x < n)
    s += star_term(p[4 * n4 + threadIdx.x], t[4 * n4 + threadIdx.x], thr, w);
  s = block_sum(s, warp_s);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket moves
    last = atomicAdd(&star_l1_ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float v = 0.f;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += SL_THREADS)
    v += __ldcg(part + i);  // from L2: other blocks wrote them
  v = block_sum(v, warp_s);
  if (threadIdx.x == 0) {
    out[0] = v / (float)n;
    star_l1_ticket = 0u;
  }
}

// Kernel 14's backward: dp = sign(p - t) * w(t) * g / n, float4 chunks
// (the n % 4 tail in block 0).
__device__ __forceinline__ float star_grad(float p, float t, float thr,
                                           float w, float scale) {
  const float diff = p - t;
  const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
  return sgn * (t > thr ? w : 1.f) * scale;
}

__global__ void __launch_bounds__(SL_THREADS)
    star_l1_bwd_kernel(const float* __restrict__ p,
                       const float* __restrict__ t, size_t n, float thr,
                       float w, const float* __restrict__ g,
                       float* __restrict__ dp) {
  const float scale = g[0] / (float)n;
  const size_t n4 = n / 4;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* t4 = reinterpret_cast<const float4*>(t);
  float4* d4 = reinterpret_cast<float4*>(dp);
  for (size_t i = (size_t)blockIdx.x * SL_THREADS + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * SL_THREADS) {
    const float4 pv = __ldg(p4 + i), tv = __ldg(t4 + i);
    d4[i] = make_float4(star_grad(pv.x, tv.x, thr, w, scale),
                        star_grad(pv.y, tv.y, thr, w, scale),
                        star_grad(pv.z, tv.z, thr, w, scale),
                        star_grad(pv.w, tv.w, thr, w, scale));
  }
  const size_t i = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && i < n) dp[i] = star_grad(p[i], t[i], thr, w, scale);
}

unsigned grid_for(size_t n, int threads, unsigned cap) {
  const size_t blocks = (n + threads - 1) / threads;
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// wgrad_kernel's partials, then wgrad_reduce_kernel (train_wgrad).
template <typename T>
int wgrad_launch(const void* in0, int in0_stride, int cin0, const void* in1,
                 int in1_stride, int cin1, const void* d, int d_stride,
                 int cout, int B, int H, int W, int seg_stride, int seg_valid,
                 int nchunk, void* part, void* dw, void* db,
                 cudaStream_t s) {
  const int cin = cin0 + cin1;
  const size_t nw = (size_t)9 * cin * cout;
  WgradArgs<T> a;
  a.in0 = static_cast<const T*>(in0);
  a.in0_stride = in0_stride;
  a.cin0 = cin0;
  a.in1 = static_cast<const T*>(in1);
  a.in1_stride = in1_stride;
  a.cin1 = cin1;
  a.d = static_cast<const T*>(d);
  a.d_stride = d_stride;
  a.cout = cout;
  a.B = B;
  a.H = H;
  a.W = W;
  a.seg_stride = seg_stride;
  a.seg_valid = seg_valid;
  a.part_w = static_cast<float*>(part);
  a.part_b = db ? a.part_w + (size_t)nchunk * nw : nullptr;
  a.nchunk = nchunk;
  const dim3 grid(nchunk, (cin + WG_CI - 1) / WG_CI, (cout + WG_CO - 1) / WG_CO);
  wgrad_kernel<T><<<grid, WG_THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wgrad_reduce_kernel<T><<<(unsigned)((nw + RED_THREADS - 1) / RED_THREADS),
                           RED_THREADS, 0, s>>>(a.part_w, nw, a.part_b, cout,
                                                nchunk, static_cast<T*>(dw),
                                                static_cast<float*>(db));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of kernel 14's forward for n elements: the f32 partial slots
// star_l1_value needs.
int train_star_l1_parts(size_t n) {
  return (int)grid_for((n + 3) / 4, SL_THREADS, 1056);
}

// Kernel 14's forward, one launch. Returns the cudaError_t of the launch
// (0 on success).
int train_star_l1_value(const void* p, const void* t, size_t n, float thr,
                        float w, void* part, void* out, void* stream) {
  star_l1_fwd_kernel<<<grid_for((n + 3) / 4, SL_THREADS, 1056), SL_THREADS,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(t), n, thr, w,
      static_cast<float*>(part), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

int train_star_l1_grad(const void* p, const void* t, size_t n, float thr,
                       float w, const void* g, void* dp, void* stream) {
  star_l1_bwd_kernel<<<grid_for((n + 3) / 4, SL_THREADS, 4224), SL_THREADS,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(t), n, thr, w,
      static_cast<const float*>(g), static_cast<float*>(dp));
  return (int)cudaGetLastError();
}

// dW [nw] bf16 = the chunks' partials summed in order (and db [cout] f32
// from the partials after them when with_bias): one launch of
// wgrad_reduce_kernel over `part` as train_wgrad lays it out.
int train_wgrad_reduce(const void* part, size_t nw, int cout, int nchunk,
                       int with_bias, void* dw, void* db, void* stream) {
  const float* pw = static_cast<const float*>(part);
  wgrad_reduce_kernel<<<(unsigned)((nw + RED_THREADS - 1) / RED_THREADS),
                        RED_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pw, nw, with_bias ? pw + (size_t)nchunk * nw : nullptr, cout, nchunk,
      static_cast<__nv_bfloat16*>(dw), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

// f32 != 0: in and out f32, else bf16.
int train_dense_scale(const void* in, size_t npix, int c, float scale,
                      void* out, int out_stride, int f32, void* stream) {
  const unsigned blocks = grid_for(npix * c, EW_THREADS, 4224);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    dense_scale_kernel<<<blocks, EW_THREADS, 0, s>>>(
        static_cast<const float*>(in), npix, c, scale,
        static_cast<float*>(out), out_stride);
  else
    dense_scale_kernel<<<blocks, EW_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(in), npix, c, scale,
        static_cast<__nv_bfloat16*>(out), out_stride);
  return (int)cudaGetLastError();
}

// Pixel chunks wgrad uses for a conv of cin -> cout over B x H x W: about
// four blocks per SM in all, at most one per pixel tile.
int train_wgrad_chunks(int B, int H, int W, int cin, int cout) {
  const int tiles = B * ((H + WG_TH - 1) / WG_TH) * ((W + WG_TW - 1) / WG_TW);
  const int per = ((cin + WG_CI - 1) / WG_CI) * ((cout + WG_CO - 1) / WG_CO);
  int n = (4 * 132 + per - 1) / per;
  if (n > tiles) n = tiles;
  return n < 1 ? 1 : n;
}

// dW [3,3,cin0+cin1,cout] and, when db is not null, db [cout] f32, over
// the chunks' partials in `part` (f32, at least nchunk * (9 * cin * cout
// + cout) floats); the activations and dW bf16 or, with f32 != 0, f32.
int train_wgrad(const void* in0, int in0_stride, int cin0, const void* in1,
                int in1_stride, int cin1, const void* d, int d_stride,
                int cout, int B, int H, int W, int seg_stride,
                int seg_valid, int nchunk, void* part, void* dw, void* db,
                int f32, void* stream) {
  if (seg_stride != 0 && (seg_valid < 1 || seg_valid > seg_stride))
    return (int)cudaErrorInvalidValue;
  return f32 ? wgrad_launch<float>(in0, in0_stride, cin0, in1, in1_stride,
                                   cin1, d, d_stride, cout, B, H, W,
                                   seg_stride, seg_valid, nchunk, part, dw,
                                   db, static_cast<cudaStream_t>(stream))
             : wgrad_launch<__nv_bfloat16>(
                   in0, in0_stride, cin0, in1, in1_stride, cin1, d, d_stride,
                   cout, B, H, W, seg_stride, seg_valid, nchunk, part, dw, db,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
