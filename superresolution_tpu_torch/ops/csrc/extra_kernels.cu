// Hand-written CUDA kernel 17 of the reference's last Pallas kernels
// outside benchmarks/ (sm_90a). No path of the system runs it; it is its
// own public op. (16, the pad-once dense block, is in
// dense_valid_kernels.cu, on the conv engine's two bodies; 18
// pack_conv3x3, the engine's PackConv policy, in pack_kernels.cu; 19, the
// passthrough, in stream_kernels.cu: each its own source, so that nvcc
// builds them side by side.)
//
//   17 anti_checkerboard  (replaces ops/pallas_blur.py:
//      anti_checkerboard_pallas, _kernel): the depthwise binomial blur
//      with SAME zero padding, f32 sums, one rounding. A block stages a
//      halo tile in shared memory once (16-byte cp.async, zeros outside
//      the image); each thread slides down a run of 16 bytes of output,
//      separable: a row pass and a column pass with the integer binomial
//      row, one scale by 1 / norm (see blur_kernel).
//
// Bound on the H100 (3.35 TB/s): k^2 MACs per 2-4 bytes in and out, so
// bytes bound it: it reads each input byte from HBM about once (the
// tile's halo rows and columns come again from L2) and does 2k FMAs an
// output.

#include <stdint.h>

#include "conv_engine.cuh"

namespace {

using conv_engine::bf16;
using conv_engine::store;
using conv_engine::to_f;
namespace ce = conv_engine;

// Faults the checks in chip_smoke.py plant (0 in every other launch).
constexpr int PLANT_NORM = 1;        // 17: divided by the row's sum, not
                                     //     the mode's 2-D norm
constexpr int PLANT_CORNER = 2;      // 17: the top-left tap dropped

// ---- kernel 17 --------------------------------------------------------
//
// A block stages its tile once: th + k - 1 rows of a run of tl + 2 hl
// elements of the chunk-space row (pixel p, channel c of the chunk at
// element p * cc + c), with 16-byte cp.async where the runs are aligned,
// zeros outside the image. In that row the horizontal tap dx of element s
// is element s + (dx - r) * cc, and SAME padding is the zero-filled halo,
// so one body serves C 1 (taps are neighbours: three aligned vectors hold
// a run's window) and C % 8 == 0 (taps are aligned vectors). Each thread
// owns a run of V adjacent elements (16 bytes) in RUN output rows: it
// slides down its rows, forms each input row's horizontal sum with the
// integer binomial row (exact in f32 for bf16 inputs), adds it into the
// RUN outputs it reaches with the vertical row, then scales once by 1 /
// norm and stores 16 bytes at a time.

constexpr int BLUR_MAX = 7;
constexpr int BLUR_RUN = 8;     // output rows a thread
constexpr int BLUR_CMAX = 64;   // channels a chunk (grid z: image, chunk)
constexpr int BLUR_NX = 128;    // threads across a tile at most
constexpr int BLUR_THREADS = 256;  // threads a block at most
enum BlurTaps { TAPS_ROW = 0, TAPS_VEC = 1, TAPS_SCALAR = 2 };

struct BlurArgs {
  const void* x;
  void* out;
  int B, H, W, C;
  int cc, chunks;    // channels a chunk, chunks an image
  int tl, th, hl;    // tile: elements, rows; halo elements (multiple of V)
  int vec, plant;    // vec: every 16-byte run aligned and whole
  float row[BLUR_MAX];  // the binomial row C(k-1, i)
  float scale;          // 1 / norm
};

__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 g = __bfloat1622float2(h[i]);
    f[2 * i] = g.x, f[2 * i + 1] = g.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

template <typename T, int K, int TAPS>
__global__ void __launch_bounds__(BLUR_THREADS)
    blur_kernel(const BlurArgs a) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = K / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const T* x = static_cast<const T*>(a.x);
  const int sw = a.tl + 2 * a.hl;  // staged row, elements
  const int rows = a.th + K - 1;
  const int lc = a.W * a.cc;       // chunk-space row, elements
  const int e0 = blockIdx.x * a.tl, y0 = blockIdx.y * a.th;
  const int b = blockIdx.z / a.chunks;
  const int c0 = (blockIdx.z - b * a.chunks) * a.cc;
  const int nthr = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  // element s of image row yy in chunk space, and whether it is in the map
  auto at = [&](int yy, int s) {
    const int p = s / a.cc;
    return (((size_t)b * a.H + yy) * a.W + p) * a.C + c0 + (s - p * a.cc);
  };
  auto inside = [&](int yy, int s) {
    return yy >= 0 && yy < a.H && s >= 0 && s < lc && c0 + s % a.cc < a.C;
  };
  if (a.vec) {
    const int nv = sw / V;
    for (int e = tid; e < rows * nv; e += nthr) {
      const int r = e / nv, q = (e - r * nv) * V;
      const int s = e0 - a.hl + q, yy = y0 - R + r;
      const bool ok = inside(yy, s);
      ce::cp_async16_zfill(ce::smem_u32(tile + r * sw + q),
                           ok ? x + at(yy, s) : x, ok ? 16 : 0);
    }
    ce::cp_async_commit();
    ce::cp_async_wait<0>();
  } else {
    for (int e = tid; e < rows * sw; e += nthr) {
      const int r = e / sw, s = e0 - a.hl + (e - r * sw), yy = y0 - R + r;
      store(&tile[e], inside(yy, s) ? to_f(x[at(yy, s)]) : 0.f);
    }
  }
  __syncthreads();

  const int j = threadIdx.x * V;          // the thread's run in the tile
  const int t0 = threadIdx.y * BLUR_RUN;  // its first output row in the tile
  float acc[BLUR_RUN][V];
#pragma unroll
  for (int o = 0; o < BLUR_RUN; ++o)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[o][v] = 0.f;
#pragma unroll
  for (int i = 0; i < BLUR_RUN + K - 1; ++i) {
    // staged row t0 + i is image row y0 + t0 + i - R; c: its centre taps
    const T* c = tile + (t0 + i) * sw + a.hl + j;
    float h[V];
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = 0.f;
    if constexpr (TAPS == TAPS_ROW) {  // cc == 1, hl == V: elements j - V ..
      float win[3 * V];
      load16(c - V, win);
      load16(c, win + V);
      load16(c + V, win + 2 * V);
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
#pragma unroll
        for (int v = 0; v < V; ++v)
          h[v] = fmaf(a.row[dx], win[V + v + dx - R], h[v]);
    } else if constexpr (TAPS == TAPS_VEC) {  // cc % V == 0
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        float tap[V];
        load16(c + (dx - R) * a.cc, tap);
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] = fmaf(a.row[dx], tap[v], h[v]);
      }
    } else {
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
#pragma unroll
        for (int v = 0; v < V; ++v)
          h[v] = fmaf(a.row[dx], to_f(c[v + (dx - R) * a.cc]), h[v]);
    }
#pragma unroll
    for (int o = 0; o < BLUR_RUN; ++o) {
      if (i - o >= 0 && i - o < K) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[o][v] = fmaf(a.row[i - o], h[v], acc[o][v]);
      }
    }
  }

  T* out = static_cast<T*>(a.out);
  const int s0 = e0 + j;
  const bool corner = a.plant & PLANT_CORNER;
#pragma unroll
  for (int o = 0; o < BLUR_RUN; ++o) {
    const int yy = y0 + t0 + o;
    if (yy >= a.H) break;
    float f[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float sum = acc[o][v];
      if (corner)  // the tap (dy 0, dx 0), image pixel (y - r, x - r)
        sum -= a.row[0] * a.row[0] *
               to_f(tile[(t0 + o) * sw + a.hl + j + v - R * a.cc]);
      f[v] = sum * a.scale;
    }
    if (a.vec && s0 + V <= lc) {
      // a vec run lies in one pixel and is all real channels or none (C,
      // cc and c0 are multiples of V): the last chunk's padding is not
      // stored, or it would land on the next pixel's channels
      if (inside(yy, s0)) store16(out + at(yy, s0), f);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (inside(yy, s0 + v)) store(out + at(yy, s0 + v), f[v]);
    }
  }
}

__global__ void noop_kernel() {}

template <typename T, int K, int TAPS>
int launch_blur(const BlurArgs& a, dim3 grid, dim3 block, size_t bytes,
                cudaStream_t s) {
  const cudaError_t e = ce::allow_smem<blur_kernel<T, K, TAPS>>(bytes);
  if (e != cudaSuccess) return (int)e;
  blur_kernel<T, K, TAPS><<<grid, block, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_blur(const BlurArgs& a, int taps, dim3 grid, dim3 block,
                size_t bytes, cudaStream_t s) {
  return taps == TAPS_ROW ? launch_blur<T, K, TAPS_ROW>(a, grid, block, bytes, s)
         : taps == TAPS_VEC
             ? launch_blur<T, K, TAPS_VEC>(a, grid, block, bytes, s)
             : launch_blur<T, K, TAPS_SCALAR>(a, grid, block, bytes, s);
}

}  // namespace

extern "C" {

// Kernel 17: out = the depthwise SAME blur of x [B, H, W, C] (f32: 1 for
// f32, 0 for bf16) by the k x k binomial / norm: the binomial row of k
// taps as ops/blur.binomial_kernel builds it, both passes with the integer
// row, one scale by 1 / norm.
int extra_blur(const void* x, void* out, int B, int H, int W, int C, int k,
               double norm, int f32, int plant, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || k < 3 || k > BLUR_MAX || !(k & 1))
    return (int)cudaErrorInvalidValue;
  BlurArgs a;
  a.x = x;
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.plant = plant;
  double sum = 0.0;
  for (int i = 0; i < k; ++i) {
    double v = 1.0;  // C(k-1, i)
    for (int t = 0; t < i; ++t) v = v * (k - 1 - t) / (t + 1);
    a.row[i] = (float)v;
    sum += v;
  }
  if (plant & PLANT_NORM) norm = sum;
  a.scale = (float)(1.0 / norm);
  const int V = f32 ? 4 : 8;
  a.cc = C < BLUR_CMAX ? C : BLUR_CMAX;
  a.chunks = (C + a.cc - 1) / a.cc;
  const long long lc = (long long)W * a.cc;
  if (lc > 0x3fffffffll) return (int)cudaErrorInvalidValue;
  a.hl = ((k / 2) * a.cc + V - 1) / V * V;
  a.vec = a.cc == C ? lc % V == 0 : (a.cc % V == 0 && C % V == 0);
  const int taps =
      a.cc == 1 ? TAPS_ROW : (a.cc % V == 0 ? TAPS_VEC : TAPS_SCALAR);
  const long long runs = (lc + V - 1) / V;  // 16-byte runs of a row
  const int nx = (int)(runs < BLUR_NX ? runs : BLUR_NX);
  a.tl = nx * V;
  const long long gx = (lc + a.tl - 1) / a.tl, gz = (long long)B * a.chunks;
  int sms = 0;
  const cudaError_t e = ce::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  // the most rows a tile (thread rows of BLUR_RUN) that stays within
  // BLUR_THREADS and still gives two blocks an SM
  int ny = 4;
  while (ny > 1 && (nx * ny > BLUR_THREADS ||
                    gx * ((H + BLUR_RUN * ny - 1) / (BLUR_RUN * ny)) * gz <
                        2ll * sms))
    ny /= 2;
  a.th = BLUR_RUN * ny;
  const long long gy = (H + a.th - 1) / a.th;
  if (gx > 0x7fffffffll || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      (size_t)(a.th + k - 1) * (a.tl + 2 * a.hl) * (f32 ? 4 : 2);
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz), block(nx, ny);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k * 2 + f32) {
    case 6: return launch_blur<bf16, 3>(a, taps, grid, block, bytes, s);
    case 7: return launch_blur<float, 3>(a, taps, grid, block, bytes, s);
    case 10: return launch_blur<bf16, 5>(a, taps, grid, block, bytes, s);
    case 11: return launch_blur<float, 5>(a, taps, grid, block, bytes, s);
    case 14: return launch_blur<bf16, 7>(a, taps, grid, block, bytes, s);
    case 15: return launch_blur<float, 7>(a, taps, grid, block, bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// An empty kernel, launched as the blur is: the floor under a launch
// through this path (chip_smoke.py's phase 36 prints it).
int extra_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
