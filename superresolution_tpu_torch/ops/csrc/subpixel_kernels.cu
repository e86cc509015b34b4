// Hand-written CUDA kernel of the sub-pixel heads (sm_90a): kernel 15.
//
//   15 conv3x3_depth_to_space  (replaces superresolution_tpu/ops/
//      pallas_kernels.py:fused_conv3x3_depth_to_space, _kernel): a 3x3
//      SAME conv to C_out*r^2 channels and the pixel shuffle in one pass.
//      Output channel o = c*r^2 + i*r + j of LR pixel (y, x) goes to HR
//      pixel (y*r + i, x*r + j), channel c (torch.PixelShuffle's order).
//      The shuffle is the store address: the C_out*r^2 intermediate never
//      exists in device memory, which is the point of the TPU kernel.
//
// Layouts. x is the model's [B, C_in, H, W] activation as it lies in
// memory, any strides (the port's convs hand it over channels-last); the
// staging loop walks channels fastest when the channel stride is 1 and
// columns fastest otherwise, so either layout is read in runs. w is the
// conv's own OIHW [C_out*r^2, C_in, 3, 3] and bias [C_out*r^2] (or null),
// both in x's type. out is [B, H*r, W*r, C_out], channels last. Every
// value is accumulated in f32 and stored in x's type (bf16 or f32).
//
// None of the TPU blocking carries over (pre-padded row bands fetched by
// manual DMA, H % th == 0, the in-kernel 5-D relayout Mosaic refused):
// one block takes a TH x TW tile of LR pixels times CO_T of the conv's
// output channels, stages the input tile with a 1-pixel halo (zero
// outside the image: SAME padding at every border, any H and W) and the
// chunk's weights in shared memory as f32, CK input channels at a time,
// and each thread accumulates PPT adjacent pixels times CO_T/NCG
// channels in registers. The block's channels are taken in sub-pixel-
// major order (q = s*C_out + c, s = i*r + j), so a thread holds
// consecutive c of one sub-pixel and its stores run along the HR pixel's
// channels.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s; ridge ~295 FLOP a
// byte): EDSR's stages (C_in 64 -> 256) do 9*64*256 MACs a pixel for
// 128 + 512 bytes, so they are bound by operations; ESPCN's head (32 ->
// 16) by bytes. This first form runs f32 FFMA on the CUDA cores (67
// TFLOP/s peak, ~7% of the bf16 bound at best); an implicit GEMM on the
// tensor cores (wgmma, TMA) is the way to the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 8;     // LR rows per block
constexpr int TW = 32;    // LR columns per block
constexpr int CK = 8;     // input channels staged per chunk
constexpr int PPT = 4;    // adjacent LR pixels per thread (along W)
constexpr int NCG = 4;    // channel groups per block
constexpr int NTHREADS = (TH * TW / PPT) * NCG;  // 256

// Faults the check in chip_smoke.py plants (0 in every other launch).
constexpr int PLANT_SWAP_IJ = 1;  // sub-pixel (i, j) stored at (j, i)
constexpr int PLANT_CLAMP = 2;    // border read clamped, not zero
constexpr int PLANT_NO_BIAS = 3;  // bias dropped

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* x;
  long long sb, sc, sy, sx;  // x's strides in elements, NCHW order
  int B, H, W, cin;
  const void* w;     // [cout*r*r][cin][3][3]
  const void* bias;  // [cout*r*r] or null
  void* out;         // [B][H*r][W*r][cout]
  int cout, r, plant;
};

template <typename T, int CO_T>
__global__ void __launch_bounds__(NTHREADS, 2) subpixel_kernel(const Args a) {
  constexpr int CPT = CO_T / NCG;
  constexpr int IH = TH + 2, IW = TW + 2;
  static_assert(CPT % 4 == 0, "CPT must be a multiple of 4");
  __shared__ float in_s[CK * IH * IW];
  __shared__ __align__(16) float w_s[9 * CK * CO_T];

  const T* x = static_cast<const T*>(a.x);
  const T* wt = static_cast<const T*>(a.w);
  const T* bias = static_cast<const T*>(a.bias);
  T* out = static_cast<T*>(a.out);
  const int rr = a.r * a.r;
  const int nq = a.cout * rr;
  const int n_qt = (nq + CO_T - 1) / CO_T;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int b = blockIdx.z / n_qt;
  const int q0 = (blockIdx.z % n_qt) * CO_T;

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pid = tid / NCG;
  const int ty = pid / (TW / PPT);
  const int tx = (pid % (TW / PPT)) * PPT;
  const bool chan_fast = a.sc == 1;
  const T* xb = x + (size_t)b * a.sb;

  float acc[PPT][CPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[p][k] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += CK) {
    for (int e = tid; e < CK * IH * IW; e += NTHREADS) {
      int ci, pix;
      if (chan_fast) {
        ci = e % CK;
        pix = e / CK;
      } else {
        ci = e / (IH * IW);
        pix = e % (IH * IW);
      }
      const int px = pix % IW;
      const int py = pix / IW;
      int gy = y0 + py - 1;
      int gx = x0 + px - 1;
      const int c = c0 + ci;
      if (a.plant == PLANT_CLAMP) {
        gy = min(max(gy, 0), a.H - 1);
        gx = min(max(gx, 0), a.W - 1);
      }
      float v = 0.f;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < a.cin)
        v = to_f(xb[c * a.sc + gy * a.sy + gx * a.sx]);
      in_s[(ci * IH + py) * IW + px] = v;
    }
    for (int e = tid; e < 9 * CK * CO_T; e += NTHREADS) {
      const int co = e % CO_T;
      const int ci = (e / CO_T) % CK;
      const int tap = e / (CO_T * CK);
      const int c = c0 + ci;
      const int q = q0 + co;
      float v = 0.f;
      if (c < a.cin && q < nq) {
        const int o = (q % a.cout) * rr + q / a.cout;
        v = to_f(wt[((size_t)o * a.cin + c) * 9 + tap]);
      }
      w_s[(tap * CK + ci) * CO_T + co] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xv[PPT + 2];
#pragma unroll
        for (int j = 0; j < PPT + 2; ++j)
          xv[j] = in_s[(ci * IH + ty + ky) * IW + tx + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wr = &w_s[((ky * 3 + kx) * CK + ci) * CO_T + cg * CPT];
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
  const int wr_ = a.W * a.r;
  const size_t hr_rows = (size_t)a.H * a.r;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int q = q0 + cg * CPT + k;
    if (q >= nq) break;
    const int s = q / a.cout;
    const int c = q - s * a.cout;
    int i = s / a.r;
    int j = s - i * a.r;
    if (a.plant == PLANT_SWAP_IJ) {
      const int t = i;
      i = j;
      j = t;
    }
    float bv = 0.f;
    if (bias != nullptr && a.plant != PLANT_NO_BIAS)
      bv = to_f(bias[c * rr + s]);
    const size_t row = ((size_t)b * hr_rows + (size_t)gy * a.r + i) * wr_;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int gx = x0 + tx + p;
      if (gx >= a.W) break;
      store(&out[(row + (size_t)gx * a.r + j) * a.cout + c], acc[p][k] + bv);
    }
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t s) {
  const int nq = a.cout * a.r * a.r;
  const int co_t = nq <= 16 ? 16 : (nq <= 32 ? 32 : 64);
  const long long nz = (long long)a.B * ((nq + co_t - 1) / co_t);
  if (nz > 65535 || (a.H + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, (unsigned)nz);
  if (co_t == 16)
    subpixel_kernel<T, 16><<<grid, NTHREADS, 0, s>>>(a);
  else if (co_t == 32)
    subpixel_kernel<T, 32><<<grid, NTHREADS, 0, s>>>(a);
  else
    subpixel_kernel<T, 64><<<grid, NTHREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel 15. f32: 1 for f32 tensors, 0 for bf16. x strides in elements
// (NCHW order); plant is 0 but in the check that plants faults. Returns
// the cudaError_t of the launch (0 on success).
int subpixel_conv3x3_d2s(const void* x, long long sb, long long sc,
                         long long sy, long long sx, int B, int H, int W,
                         int cin, const void* w, const void* bias, int cout,
                         int r, void* out, int f32, int plant, void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin < 1 || cout < 1 || r < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.sb = sb;
  a.sc = sc;
  a.sy = sy;
  a.sx = sx;
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.w = w;
  a.bias = bias;
  a.out = out;
  a.cout = cout;
  a.r = r;
  a.plant = plant;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(a, s) : launch<bf16>(a, s);
}

}  // extern "C"
