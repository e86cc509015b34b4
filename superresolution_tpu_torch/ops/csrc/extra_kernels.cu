// Hand-written CUDA kernels of the reference's last Pallas kernels outside
// benchmarks/ (sm_90a): 16, 17, 18 and 19. No path of the system runs
// them; each is its own public op.
//
//   16 fused_dense_block_valid  (replaces superresolution_tpu/ops/
//      pallas_dense.py:fused_dense_block_pallas, _kernel): one
//      FusedDenseBlock on an input zero-padded by 5 ONCE, its five convs
//      chained VALID. Five launches of conv_kernel<DenseStage>, stage j
//      over the padded frame's region [j, H+10-j) x [j, W+10-j), each 2
//      rows and 2 columns narrower than the one before. Stages 1-4 write
//      y_j = lrelu(conv_j([x, y_1..y_{j-1}]) + b_j) into a [B, H+8, W+8,
//      4g] workspace (frame pixel (r, s) at (r-1, s-1)); stage 5 writes
//      x + 0.2 * (conv_5(...) + b_5) over the image. Outside the image
//      the intermediates hold lrelu(bias + ...), not zero: a stage reads
//      x through the zero padding and every y_i where it was computed,
//      so nothing is masked. (B1's SAME conv would zero them: that
//      differs within 4 px of the border.) The weights are read in place
//      from the reference's tap-major projection matrices (wx [9c, 4g+c],
//      w_i [9g, (4-i)g+c]): conv_j's columns are (j-1)g.. of wx and
//      (j-1-i)g.. of w_i, its bias (j-1)g.. of the one bias vector.
//   17 anti_checkerboard  (replaces ops/pallas_blur.py:
//      anti_checkerboard_pallas, _kernel): the depthwise binomial blur
//      with SAME zero padding, one thread per output value, the k x k
//      taps read through L1, f32 sums, one rounding.
//   18 pack_conv3x3  (replaces ops/pallas_pairconv.py:pack_conv3x3,
//      _kernel): a SAME 3x3 conv (+ f32 bias, optional lrelu 0.2) on the
//      W-packed layout [B, H, W2, p*c], which is the unpacked [B, H,
//      W2*p, c] in memory. One launch of conv_kernel<PackConv>: rows
//      outside the image read as zero, columns are read as they lie, pad
//      packs included (as the TPU kernel's taps read them), and every
//      output column outside the real pixels [p, p + width) is written as
//      0 so calls chain. The TPU kernel's banded pack GEMMs and rolls
//      exist for the MXU's 128-deep contraction; here the pack is only an
//      address.
//   19 passthrough  (replaces bench.py:dma_probe.make_pt): a copy, one
//      block per band of rb rows as the reference's grid has, 16-byte
//      loads and stores, four in flight a thread.
//
// Bounds on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): 16 does B1's
// 239,616 MACs per image pixel (plus the 5-px ring), bound by operations;
// 18 at the dense block's widths (9 c n MACs per pixel for 2 (c + n)
// bytes) by operations; 17 (k^2 FMAs per 2-4 bytes) and 19 by bytes. 16
// and 18 run f32 FFMA on the CUDA cores (67 TFLOP/s, ~7% of the bf16
// bound at best), as B1 and kernel 15 do; an implicit GEMM on the tensor
// cores is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Faults the checks in chip_smoke.py plant (0 in every other launch).
constexpr int PLANT_SAME = 1;        // 16: intermediates zeroed outside
                                     //     the image (SAME semantics)
constexpr int PLANT_NO_SCALE = 2;    // 16: the 0.2 residual scale dropped
constexpr int PLANT_NORM = 1;        // 17: divided by the row's sum, not
                                     //     the mode's 2-D norm
constexpr int PLANT_CORNER = 2;      // 17: the top-left tap dropped
constexpr int PLANT_PAD_KEPT = 1;    // 18: pad packs not zeroed
constexpr int PLANT_DROP_CROSS = 2;  // 18: the left tap across a pack
                                     //     edge dropped
constexpr int PLANT_LAST_BAND = 1;   // 19: the last band not copied

// ---- the direct 3x3 conv of kernels 16 and 18 ------------------------
//
// One block: a TH x TW tile of the output region times CO_T output
// channels. Per chunk of CK input channels, the input tile with a
// 1-pixel halo (P::load gives zero where the op's frame has none) and
// the chunk's weights are staged in shared memory as f32; each thread
// accumulates PPT adjacent pixels times CO_T / NCG channels in
// registers and hands each sum to P::put. The same blocking as kernel
// 15 (subpixel_kernels.cu).

constexpr int TH = 8;     // output rows per block
constexpr int TW = 32;    // output columns per block
constexpr int CK = 8;     // input channels staged per chunk
constexpr int PPT = 4;    // adjacent output pixels per thread (along W)
constexpr int NCG = 4;    // channel groups per block
constexpr int NTHREADS = (TH * TW / PPT) * NCG;  // 256

// Kernel 16, stage j (1..5), in the frame of x padded by 5.
template <typename T>
struct DenseStage {
  const T* x;           // [B, H, W, c]
  T* ws;                // [B, H+8, W+8, 4g]: frame pixel (r, s) at (r-1, s-1)
  T* out;               // [B, H, W, c], stage 5
  const T* w[5];        // wx [9c][cols[0]], w_i [9g][cols[i]]
  int cols[5];
  const float* bias;    // [4g + c]
  int B, H, W, c, g, j, plant;
  __host__ __device__ int cin() const { return c + (j - 1) * g; }
  __host__ __device__ int cout() const { return j < 5 ? g : c; }
  __host__ __device__ int y0() const { return j; }
  __host__ __device__ int x0() const { return j; }
  __host__ __device__ int rows() const { return H + 10 - 2 * j; }
  __host__ __device__ int cols_out() const { return W + 10 - 2 * j; }
  __device__ __forceinline__ float load(int b, int r, int s, int ci) const {
    if (ci < c) {
      const int y = r - 5, xx = s - 5;
      if (y < 0 || y >= H || xx < 0 || xx >= W) return 0.f;
      return to_f(x[(((size_t)b * H + y) * W + xx) * c + ci]);
    }
    // y_1..y_{j-1}: defined wherever an in-region output reads them;
    // the guard only keeps a ragged tile's extra reads inside the buffer
    if (r < 1 || r > H + 8 || s < 1 || s > W + 8) return 0.f;
    return to_f(ws[(((size_t)b * (H + 8) + r - 1) * (W + 8) + s - 1) *
                       (4 * g) + (ci - c)]);
  }
  __device__ __forceinline__ float weight(int tap, int ci, int o) const {
    if (ci < c) return to_f(w[0][((size_t)tap * c + ci) * cols[0] +
                                 (j - 1) * g + o]);
    const int i = (ci - c) / g + 1;  // source y_i
    const int ch = (ci - c) - (i - 1) * g;
    return to_f(w[i][((size_t)tap * g + ch) * cols[i] + (j - 1 - i) * g + o]);
  }
  __device__ __forceinline__ void put(int b, int r, int s, int o,
                                      float acc) const {
    float v = acc + bias[(j - 1) * g + o];
    if (j < 5) {
      v = lrelu(v);
      if ((plant & PLANT_SAME) &&
          (r < 5 || r >= H + 5 || s < 5 || s >= W + 5))
        v = 0.f;
      store(&ws[(((size_t)b * (H + 8) + r - 1) * (W + 8) + s - 1) * (4 * g) +
                (j - 1) * g + o], v);
      return;
    }
    const size_t at = (((size_t)b * H + r - 5) * W + s - 5) * c + o;
    const float scale = (plant & PLANT_NO_SCALE) ? 1.f : 0.2f;
    store(&out[at], to_f(x[at]) + scale * v);
  }
  __device__ __forceinline__ bool dropped(int, int) const { return false; }
};

// Kernel 18 on the unpacked view [B, H, Wp = W2*p, c] of xp.
template <typename T>
struct PackConv {
  const T* x;           // [B, H, Wp, c]
  const T* w;           // [3][3][c][n], HWIO = [9c][n]
  const float* bias;    // [n]
  T* out;               // [B, H, Wp, n]
  int B, H, Wp, c, n, p, width, act, plant;
  __host__ __device__ int cin() const { return c; }
  __host__ __device__ int cout() const { return n; }
  __host__ __device__ int y0() const { return 0; }
  __host__ __device__ int x0() const { return 0; }
  __host__ __device__ int rows() const { return H; }
  __host__ __device__ int cols_out() const { return Wp; }
  __device__ __forceinline__ float load(int b, int y, int xx, int ci) const {
    if (y < 0 || y >= H || xx < 0 || xx >= Wp) return 0.f;
    return to_f(x[(((size_t)b * H + y) * Wp + xx) * c + ci]);
  }
  __device__ __forceinline__ float weight(int tap, int ci, int o) const {
    return to_f(w[((size_t)tap * c + ci) * n + o]);
  }
  __device__ __forceinline__ void put(int b, int y, int xx, int o,
                                      float acc) const {
    float v = 0.f;
    if ((xx >= p && xx < p + width) || (plant & PLANT_PAD_KEPT)) {
      v = acc + bias[o];
      if (act) v = lrelu(v);
    }
    store(&out[(((size_t)b * H + y) * Wp + xx) * n + o], v);
  }
  // PLANT_DROP_CROSS: the first pixel of each pack loses its left tap
  __device__ __forceinline__ bool dropped(int xx, int kx) const {
    return kx == 0 && xx % p == 0;
  }
};

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
    for (int ci = 0; ci < CK; ++ci) {
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

template <class P, bool DROP>
int launch_conv(const P& a, cudaStream_t s) {
  const int co_t = a.cout() <= 32 ? 32 : 64;
  const long long nz = (long long)a.B * ((a.cout() + co_t - 1) / co_t);
  const int ny = (a.rows() + TH - 1) / TH;
  if (nz > 65535 || ny > 65535 || a.rows() < 1 || a.cols_out() < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.cols_out() + TW - 1) / TW, ny, (unsigned)nz);
  if (co_t == 32)
    conv_kernel<P, 32, DROP><<<grid, NTHREADS, 0, s>>>(a);
  else
    conv_kernel<P, 64, DROP><<<grid, NTHREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- kernel 17 --------------------------------------------------------

constexpr int BLUR_MAX = 7;

struct BlurArgs {
  const void* x;
  void* out;
  int B, H, W, C, k, plant;
  float coef[BLUR_MAX * BLUR_MAX];
};

template <typename T>
__global__ void __launch_bounds__(256) blur_kernel(const BlurArgs a) {
  const size_t n = (size_t)a.B * a.H * a.W * a.C;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* x = static_cast<const T*>(a.x);
  const int c = (int)(i % a.C);
  const size_t pix = i / a.C;
  const int xx = (int)(pix % a.W);
  const size_t row = pix / a.W;
  const int y = (int)(row % a.H);
  const size_t b = row / a.H;
  const int r = a.k / 2;
  float acc = 0.f;
  for (int dy = 0; dy < a.k; ++dy) {
    const int yy = y + dy - r;
    if (yy < 0 || yy >= a.H) continue;
    const T* xr = x + (b * a.H + yy) * a.W * a.C + c;
    for (int dx = 0; dx < a.k; ++dx) {
      const int xs = xx + dx - r;
      if (xs < 0 || xs >= a.W) continue;
      if ((a.plant & PLANT_CORNER) && dy == 0 && dx == 0) continue;
      acc = fmaf(a.coef[dy * a.k + dx], to_f(xr[(size_t)xs * a.C]), acc);
    }
  }
  store(static_cast<T*>(a.out) + i, acc);
}

// ---- kernel 19 --------------------------------------------------------

constexpr int COPY_THREADS = 1024;

// Block i copies band i, `vecs` 16-byte words.
__global__ void __launch_bounds__(COPY_THREADS) copy_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst, long long vecs,
    int plant) {
  if ((plant & PLANT_LAST_BAND) && blockIdx.x == gridDim.x - 1) return;
  const uint4* s = src + (size_t)blockIdx.x * vecs;
  uint4* d = dst + (size_t)blockIdx.x * vecs;
  long long i = threadIdx.x;
  for (; i + 3 * COPY_THREADS < vecs; i += 4 * COPY_THREADS) {
    const uint4 v0 = s[i], v1 = s[i + COPY_THREADS],
                v2 = s[i + 2 * COPY_THREADS], v3 = s[i + 3 * COPY_THREADS];
    d[i] = v0;
    d[i + COPY_THREADS] = v1;
    d[i + 2 * COPY_THREADS] = v2;
    d[i + 3 * COPY_THREADS] = v3;
  }
  for (; i < vecs; i += COPY_THREADS) d[i] = s[i];
}

}  // namespace

extern "C" {

// Kernel 16, stage j (1..5). f32: 1 for f32 tensors, 0 for bf16 (x, ws,
// out and the five weight matrices in that type; bias f32). w: the five
// matrix pointers. Returns the cudaError_t of the launch.
int extra_dense_valid_stage(const void* x, void* ws, void* out,
                            const void* const* w, const float* bias, int B,
                            int H, int W, int c, int g, int j, int f32,
                            int plant, void* stream) {
  if (B < 1 || H < 1 || W < 1 || c < 1 || g < 1 || j < 1 || j > 5)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols[5] = {4 * g + c, 3 * g + c, 2 * g + c, g + c, c};
  if (f32) {
    DenseStage<float> a{static_cast<const float*>(x), static_cast<float*>(ws),
                        static_cast<float*>(out), {}, {}, bias, B, H, W, c, g,
                        j, plant};
    for (int i = 0; i < 5; ++i) {
      a.w[i] = static_cast<const float*>(w[i]);
      a.cols[i] = cols[i];
    }
    return launch_conv<DenseStage<float>, false>(a, s);
  }
  DenseStage<bf16> a{static_cast<const bf16*>(x), static_cast<bf16*>(ws),
                     static_cast<bf16*>(out), {}, {}, bias, B, H, W, c, g, j,
                     plant};
  for (int i = 0; i < 5; ++i) {
    a.w[i] = static_cast<const bf16*>(w[i]);
    a.cols[i] = cols[i];
  }
  return launch_conv<DenseStage<bf16>, false>(a, s);
}

// Kernel 17. coefficients row[dy] * row[dx] / norm from the binomial row
// of `k` taps, as ops/blur.binomial_kernel computes them (f64, then f32).
int extra_blur(const void* x, void* out, int B, int H, int W, int C, int k,
               double norm, int f32, int plant, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || k < 1 || k > BLUR_MAX || !(k & 1))
    return (int)cudaErrorInvalidValue;
  BlurArgs a;
  a.x = x;
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.k = k;
  a.plant = plant;
  double row[BLUR_MAX];
  double sum = 0.0;
  for (int i = 0; i < k; ++i) {
    double v = 1.0;  // C(k-1, i)
    for (int t = 0; t < i; ++t) v = v * (k - 1 - t) / (t + 1);
    row[i] = v;
    sum += v;
  }
  if (plant & PLANT_NORM) norm = sum;
  for (int dy = 0; dy < k; ++dy)
    for (int dx = 0; dx < k; ++dx)
      a.coef[dy * k + dx] = (float)(row[dy] * row[dx] / norm);
  const size_t n = (size_t)B * H * W * C;
  const size_t blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    blur_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(a);
  else
    blur_kernel<bf16><<<(unsigned)blocks, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 18. xp viewed as [B, H, Wp, c], out [B, H, Wp, n], w [9c][n] in
// the same type (f32: 1 for f32), bias [n] f32; real columns [p, p +
// width); act 1: lrelu(0.2).
int extra_pack_conv(const void* x, const void* w, const float* bias,
                    void* out, int B, int H, int Wp, int c, int n, int p,
                    int width, int act, int f32, int plant, void* stream) {
  if (B < 1 || H < 1 || c < 1 || n < 1 || p < 1 || width < 1 ||
      p + width > Wp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = plant & PLANT_DROP_CROSS;
  if (f32) {
    const PackConv<float> a{static_cast<const float*>(x),
                            static_cast<const float*>(w), bias,
                            static_cast<float*>(out), B, H, Wp, c, n, p,
                            width, act, plant};
    return drop ? launch_conv<PackConv<float>, true>(a, s)
                : launch_conv<PackConv<float>, false>(a, s);
  }
  const PackConv<bf16> a{static_cast<const bf16*>(x),
                         static_cast<const bf16*>(w), bias,
                         static_cast<bf16*>(out), B, H, Wp, c, n, p, width,
                         act, plant};
  return drop ? launch_conv<PackConv<bf16>, true>(a, s)
              : launch_conv<PackConv<bf16>, false>(a, s);
}

// Kernel 19: bands blocks, each copying band_bytes (a multiple of 16;
// src and dst 16-byte aligned).
int extra_copy(const void* src, void* dst, long long bands,
               long long band_bytes, int plant, void* stream) {
  if (bands < 1 || bands > 0x7fffffffll || band_bytes < 16 ||
      band_bytes % 16)
    return (int)cudaErrorInvalidValue;
  copy_kernel<<<(unsigned)bands, COPY_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst),
      band_bytes / 16, plant);
  return (int)cudaGetLastError();
}

}  // extern "C"
