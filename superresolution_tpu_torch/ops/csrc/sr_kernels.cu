// Hand-written CUDA kernels of the ESRGAN RRDBNet x4 deploy path (sm_90a).
//
// One direct NHWC 3x3 SAME convolution routine with fused epilogues
// carries two of the three ops; conv_last has its own small kernel. The
// same routine also carries the two convs of the hybrid path's CAB
// (hat_kernels.cu, kernel 7), through its exact-GELU epilogue, and the
// transposed convs of the dense block's backward (train_kernels.cu,
// kernel 13), through its lrelu' gate and scaled-add epilogues.
//
//   B1 fused_dense_block  (replaces superresolution_tpu/ops/
//      pallas_dense_trunk.py:fused_dense_block): five launches of
//      conv3x3_kernel, the plain DenseBlock form. conv_j reads x (source 0)
//      and the first (j-1)*g channels of a [B,H,W,4g] workspace (source 1)
//      and writes its g channels into the workspace; conv5 writes
//      x + 0.2*conv5, or res + 0.2*(x + 0.2*conv5). Zero padding at every
//      conv is exact by construction: each conv reads its input through
//      the same zero-filled halo.
//   B2 up2_hr  (replaces ops/pallas_phase_tail.py:_up2hr_kernel): two
//      launches of conv3x3_kernel, each reading its input through the
//      depth_to_space(2) view: up2 (+bias, lrelu) at 2x, then conv_hr
//      (+bias, lrelu) at 4x.
//   B3 conv_last  (replaces ops/pallas_phase_tail.py:_last_kernel):
//      conv_last_kernel, one thread per output pixel with all its output
//      channels, weights in shared memory.
//
// Bounds on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s; the ridge is
// ~148 MACs per byte): B1 does 240 K MACs per pixel for 256-384 bytes
// (x, out, residual) and B2 1.18 M MACs per LR pixel for 2.5 KB (z1 in,
// the 4x 64-channel map out), so both are bound by operations; B3
// (64 -> 3 channels, 1.7 K MACs per 134 bytes) is bound by bytes.
//
// What this simple design leaves on the table: B1/B2 accumulate on the
// CUDA cores in f32 (FFMA, 67 TFLOP/s peak), not on the tensor cores, so
// they can reach at most ~7% of the bf16 bound; an implicit-GEMM form with
// wgmma and TMA is the way to the rest. B1 also round-trips its 4g
// workspace channels through device memory and B2 its 2x intermediate,
// which a single launch with an in-shared-memory cascade would avoid.
// B3 reads each input pixel nine times through L1 instead of staging a
// tile, and reloads its 9 KB of weights in every block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;     // output rows per block
constexpr int TW = 32;    // output columns per block
constexpr int CK = 8;     // input channels staged per chunk
constexpr int PPT = 4;    // consecutive output pixels per thread (along W)
constexpr int NCG = 4;    // output-channel groups per block
constexpr int NTHREADS = (TH * TW / PPT) * NCG;  // 256

struct ConvArgs {
  // Logical input channel c < cin0 reads source 0, else source 1 at
  // channel c - cin0. Sources are NHWC with `stride` channels per pixel.
  // With the depth_to_space(2) view, source 0 is [B, H/2, W/2, stride]
  // and logical channel f at (y, x) is its channel f*4 + (y%2)*2 + (x%2).
  const __nv_bfloat16* in0;
  int in0_stride, cin0;
  const __nv_bfloat16* in1;
  int in1_stride, cin1;
  int B, H, W;                  // geometry of the conv's (logical) input
  const __nv_bfloat16* w;       // [3][3][cin0 + cin1][cout], HWIO
  const float* bias;            // [cout] or null
  __nv_bfloat16* out;           // [B, H, W, out_stride], channels from out_off
  int out_stride, out_off, cout;
  int act;                      // 1: v = lrelu(acc + bias, 0.2);
                                // 2: v = gelu(acc + bias), exact erf
  const __nv_bfloat16* gate;    // or null: v = gate > 0 ? v : 0.2 * v
  int gate_stride;              // (lrelu' of the forward's y = lrelu(pre))
  const __nv_bfloat16* add;     // or null: v = v + add_scale * add
  int add_stride;
  float add_scale;
  const __nv_bfloat16* xres;    // or null: v = x + 0.2 * v
  int xres_stride;
  const __nv_bfloat16* res;     // or null: v = res + 0.2 * v
  int res_stride;
};

template <bool D2S>
__device__ __forceinline__ float load_in(const ConvArgs& a, int b, int y,
                                         int x, int c) {
  if (D2S) {
    const size_t pix =
        ((size_t)b * (a.H >> 1) + (y >> 1)) * (a.W >> 1) + (x >> 1);
    return __bfloat162float(
        a.in0[pix * a.in0_stride + c * 4 + (y & 1) * 2 + (x & 1)]);
  }
  const size_t pix = ((size_t)b * a.H + y) * a.W + x;
  if (c < a.cin0) return __bfloat162float(a.in0[pix * a.in0_stride + c]);
  return __bfloat162float(a.in1[pix * a.in1_stride + (c - a.cin0)]);
}

// Block: a TH x TW output tile times CO_T output channels. Per chunk of CK
// input channels, the input tile plus a 1-pixel halo (zero outside the
// image) and the chunk's 3x3 weights are staged in shared memory as f32;
// each thread accumulates PPT x (CO_T / NCG) outputs in registers.
template <int CO_T, bool D2S>
__global__ void __launch_bounds__(NTHREADS)
    conv3x3_kernel(const ConvArgs a) {
  constexpr int CPT = CO_T / NCG;
  static_assert(CPT % 4 == 0, "CPT must be a multiple of 4");
  __shared__ float in_s[CK][TH + 2][TW + 2];
  __shared__ __align__(16) float w_s[9][CK][CO_T];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pid = tid / NCG;
  const int ty = pid / (TW / PPT);
  const int tx = (pid % (TW / PPT)) * PPT;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int n_co = (a.cout + CO_T - 1) / CO_T;
  const int b = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * CO_T;
  const int cin = a.cin0 + a.cin1;

  float acc[PPT][CPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[p][k] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    for (int e = tid; e < CK * (TH + 2) * (TW + 2); e += NTHREADS) {
      const int ci = e % CK;
      const int pix = e / CK;
      const int px = pix % (TW + 2);
      const int py = pix / (TW + 2);
      const int gy = y0 + py - 1;
      const int gx = x0 + px - 1;
      const int c = c0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < cin)
        v = load_in<D2S>(a, b, gy, gx, c);
      in_s[ci][py][px] = v;
    }
    for (int e = tid; e < 9 * CK * CO_T; e += NTHREADS) {
      const int co = e % CO_T;
      const int ci = (e / CO_T) % CK;
      const int tap = e / (CO_T * CK);
      const int c = c0 + ci;
      const int o = co0 + co;
      float v = 0.f;
      if (c < cin && o < a.cout)
        v = __bfloat162float(a.w[((size_t)tap * cin + c) * a.cout + o]);
      w_s[tap][ci][co] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xv[PPT + 2];
#pragma unroll
        for (int j = 0; j < PPT + 2; ++j) xv[j] = in_s[ci][ty + ky][tx + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wr = &w_s[ky * 3 + kx][ci][cg * CPT];
#pragma unroll
          for (int k = 0; k < CPT; k += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + k);
#pragma unroll
            for (int p = 0; p < PPT; ++p) {
              const float xi = xv[p + kx];
              acc[p][k + 0] = fmaf(xi, wv.x, acc[p][k + 0]);
              acc[p][k + 1] = fmaf(xi, wv.y, acc[p][k + 1]);
              acc[p][k + 2] = fmaf(xi, wv.z, acc[p][k + 2]);
              acc[p][k + 3] = fmaf(xi, wv.w, acc[p][k + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int gy = y0 + ty;
  if (gy >= a.H) return;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int gx = x0 + tx + p;
    if (gx >= a.W) continue;
    const size_t pix = ((size_t)b * a.H + gy) * a.W + gx;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int o = co0 + cg * CPT + k;
      if (o >= a.cout) break;
      float v = acc[p][k];
      if (a.bias) v += a.bias[o];
      if (a.act == 1) v = v < 0.f ? 0.2f * v : v;
      if (a.act == 2) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      if (a.gate && !(__bfloat162float(a.gate[pix * a.gate_stride + o]) > 0.f))
        v *= 0.2f;
      if (a.add)
        v += a.add_scale * __bfloat162float(a.add[pix * a.add_stride + o]);
      if (a.xres)
        v = __bfloat162float(a.xres[pix * a.xres_stride + o]) + 0.2f * v;
      if (a.res)
        v = __bfloat162float(a.res[pix * a.res_stride + o]) + 0.2f * v;
      a.out[pix * a.out_stride + a.out_off + o] = __float2bfloat16(v);
    }
  }
}

template <int CO_T>
cudaError_t launch_conv3x3(const ConvArgs& a, int d2s, cudaStream_t s) {
  const int n_co = (a.cout + CO_T - 1) / CO_T;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, a.B * n_co);
  if (d2s)
    conv3x3_kernel<CO_T, true><<<grid, NTHREADS, 0, s>>>(a);
  else
    conv3x3_kernel<CO_T, false><<<grid, NTHREADS, 0, s>>>(a);
  return cudaGetLastError();
}

constexpr int LAST_MAX_CIN = 64;
constexpr int LAST_MAX_COUT = 4;
constexpr int LAST_THREADS = 256;

// conv_last: [B,H,W,cin] bf16 -> [B,H,W,cout] bf16, + bias. One thread per
// output pixel; cin % 8 == 0 so each tap pixel is read as 16-byte vectors.
__global__ void __launch_bounds__(LAST_THREADS)
    conv_last_kernel(const __nv_bfloat16* __restrict__ y, int B, int H,
                     int W, int cin, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, int cout,
                     __nv_bfloat16* __restrict__ out) {
  __shared__ float w_s[9 * LAST_MAX_CIN * LAST_MAX_COUT];
  for (int e = threadIdx.x; e < 9 * cin * LAST_MAX_COUT; e += blockDim.x) {
    const int co = e % LAST_MAX_COUT;
    const int rest = e / LAST_MAX_COUT;  // tap * cin + ci
    w_s[e] = co < cout ? __bfloat162float(w[(size_t)rest * cout + co]) : 0.f;
  }
  __syncthreads();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)B * H * W;
  if (idx >= total) return;
  const int x = (int)(idx % W);
  const int yy = (int)((idx / W) % H);
  const int b = (int)(idx / ((size_t)W * H));
  float acc[LAST_MAX_COUT] = {0.f, 0.f, 0.f, 0.f};
  for (int ky = 0; ky < 3; ++ky) {
    const int gy = yy + ky - 1;
    if (gy < 0 || gy >= H) continue;
    for (int kx = 0; kx < 3; ++kx) {
      const int gx = x + kx - 1;
      if (gx < 0 || gx >= W) continue;
      const uint4* src = reinterpret_cast<const uint4*>(
          y + (((size_t)b * H + gy) * W + gx) * cin);
      const float* wt = &w_s[(ky * 3 + kx) * cin * LAST_MAX_COUT];
      for (int c8 = 0; c8 < cin / 8; ++c8) {
        const uint4 raw = src[c8];
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h2[j]);
          const float* w0 = wt + (c8 * 8 + 2 * j) * LAST_MAX_COUT;
#pragma unroll
          for (int o = 0; o < LAST_MAX_COUT; ++o)
            acc[o] = fmaf(f.x, w0[o], fmaf(f.y, w0[LAST_MAX_COUT + o],
                                           acc[o]));
        }
      }
    }
  }
  for (int o = 0; o < cout; ++o)
    out[idx * cout + o] = __float2bfloat16(acc[o] + bias[o]);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int sr_conv3x3(const void* in0, int in0_stride, int cin0, const void* in1,
               int in1_stride, int cin1, int d2s, int B, int H, int W,
               const void* w, const void* bias, void* out, int out_stride,
               int out_off, int cout, int act, const void* gate,
               int gate_stride, const void* add, int add_stride,
               float add_scale, const void* xres, int xres_stride,
               const void* res, int res_stride, void* stream) {
  ConvArgs a;
  a.in0 = static_cast<const __nv_bfloat16*>(in0);
  a.in0_stride = in0_stride;
  a.cin0 = cin0;
  a.in1 = static_cast<const __nv_bfloat16*>(in1);
  a.in1_stride = in1_stride;
  a.cin1 = cin1;
  a.B = B;
  a.H = H;
  a.W = W;
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.out_stride = out_stride;
  a.out_off = out_off;
  a.cout = cout;
  a.act = act;
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.gate_stride = gate_stride;
  a.add = static_cast<const __nv_bfloat16*>(add);
  a.add_stride = add_stride;
  a.add_scale = add_scale;
  a.xres = static_cast<const __nv_bfloat16*>(xres);
  a.xres_stride = xres_stride;
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.res_stride = res_stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 32) return (int)launch_conv3x3<32>(a, d2s, s);
  return (int)launch_conv3x3<64>(a, d2s, s);
}

int sr_conv_last(const void* y, int B, int H, int W, int cin, const void* w,
                 const void* bias, int cout, void* out, void* stream) {
  if (cin > LAST_MAX_CIN || cin % 8 != 0 || cout > LAST_MAX_COUT)
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * H * W;
  const unsigned blocks = (unsigned)((total + LAST_THREADS - 1) / LAST_THREADS);
  conv_last_kernel<<<blocks, LAST_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), B, H, W, cin,
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      cout, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
