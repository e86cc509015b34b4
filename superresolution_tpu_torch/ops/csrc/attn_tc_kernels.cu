// Kernel 10's bf16 launches on the tensor cores (sm_90a): flash_tc.cuh's
// FlashAttention-2 body over windows (KEYS_WIN) and over the HAB's qkv
// map (KEYS_MAP). The function, the widths and the bound are in
// attn_kernels.cu's header; this file holds the entry points and the
// instances of the model's widths, and sends every other width to
// attn_tc_widths16.cu or attn_tc_widths20.cu (nvcc builds each file in
// parallel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The model's widths, (C, heads) (96, 6), (128, 8) and (120, 6), with the
// key counts compiled in: on windows at every (n, m), on the map at n ==
// m. (One instance a width and window side reading its key count at run
// time, as the other widths do, spills at C 96 and takes 37-39% longer
// on the H100; PERF.md's kernel 10 findings.)
template <int C, int NH, int MODE>
int dispatch_model(const flash_tc::FlashArgs& a, long long nb, int n, int m,
                   cudaStream_t s) {
  using flash_tc::launch;
  constexpr int WIN = flash_tc::KEYS_WIN;
  if (n == 64 && m == 64) return launch<C, NH, 8, 8, MODE>(a, nb, s);
  if (n == 256 && m == 256) return launch<C, NH, 16, 16, MODE>(a, nb, s);
  if constexpr (MODE == WIN) {
    if (n == 64 && m == 100) return launch<C, NH, 8, 10, WIN>(a, nb, s);
    if (n == 64 && m == 121) return launch<C, NH, 8, 11, WIN>(a, nb, s);
    if (n == 64 && m == 144) return launch<C, NH, 8, 12, WIN>(a, nb, s);
    if (n == 256 && m == 576) return launch<C, NH, 16, 24, WIN>(a, nb, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel 10 at (C, heads) on ws x ws query windows (n = ws^2): the model's
// widths here, the others by head dim and head count (attn_tc_widths16.cu,
// attn_tc_widths20.cu).
template <int MODE>
int dispatch_tc(const flash_tc::FlashArgs& a, long long nb, int n, int m,
                int C, int nh, cudaStream_t s) {
  if (C == 96 && nh == 6) return dispatch_model<96, 6, MODE>(a, nb, n, m, s);
  if (C == 120 && nh == 6)
    return dispatch_model<120, 6, MODE>(a, nb, n, m, s);
  if (C == 128 && nh == 8)
    return dispatch_model<128, 8, MODE>(a, nb, n, m, s);
  const int ws = n == 64 ? 8 : n == 256 ? 16 : 0;
  if (nh < 1 || ws == 0) return (int)cudaErrorInvalidValue;
  if (C == 16 * nh) return flash_tc::launch_width16(a, MODE, nb, ws, nh, s);
  if (C == 20 * nh) return flash_tc::launch_width20(a, MODE, nb, ws, nh, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch of kernel 10 on the tensor cores over windows (KEYS_WIN): q
// [nb, n, C], k, v [nb, m, C] bf16 with unit channel strides and the
// given window and row strides (elements; 16-byte aligned rows at head
// dim 16, 8-byte at 20; v's those of k), bias the f32 [nh, n, m] / scale
// in fragment order
// (ops/flash_oca.bias_fragments), ids [nw_img, n] int32 or null, out [nb,
// n, C] contiguous bf16. Returns the cudaError_t of the launch,
// cudaErrorInvalidValue for what it does not take.
int attn_window_tc(const void* q, long long q_bs, long long q_rs,
                   const void* k, long long k_bs, long long k_rs,
                   const void* v, long long v_bs, long long v_rs,
                   const void* bias, const void* ids, int nw_img, void* out,
                   int nb, int n, int m, int C, int nh, float scale,
                   void* stream) {
  if (nb < 1 || m < 1 || (ids && (m != n || nw_img <= 0 || nb % nw_img)) ||
      v_bs != k_bs || v_rs != k_rs)
    return (int)cudaErrorInvalidValue;
  flash_tc::FlashArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.bias = static_cast<const float4*>(bias);
  a.ids = static_cast<const int*>(ids);
  a.nw_img = nw_img;
  a.out = static_cast<bf16*>(out);
  a.nh_w = a.nw_w = 1;
  a.m = m;
  a.scale_log2 = scale * flash_tc::LOG2E;
  return dispatch_tc<flash_tc::KEYS_WIN>(a, nb, n, m, C, nh,
                                         static_cast<cudaStream_t>(stream));
}

// One launch of kernel 10 on the tensor cores over the map (KEYS_MAP, the
// HAB's self-attention): qkv [B, H, W, 3C] bf16 (q | k | v), out [B, H,
// W, C] bf16, ws x ws windows of the map rolled by -shift (H, W multiples
// of ws), bias as attn_window_tc's. plant: 0 but in the checks, which
// plant faults at (C 96, 6 heads, ws 8) only. Returns the cudaError_t of
// the launch, cudaErrorInvalidValue for what it does not take.
int attn_map_tc(const void* qkv, void* out, const void* bias, int B, int H,
                int W, int C, int nh, int ws, int shift, float scale,
                int plant, void* stream) {
  if (B < 1 || ws < 1 || H < ws || W < ws || H % ws || W % ws ||
      shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  flash_tc::FlashArgs a = {};
  a.q = static_cast<const bf16*>(qkv);
  a.bias = static_cast<const float4*>(bias);
  a.out = static_cast<bf16*>(out);
  a.nh_w = H / ws;
  a.nw_w = W / ws;
  a.hp = H;
  a.wp = W;
  a.shift = shift;
  a.scale_log2 = scale * flash_tc::LOG2E;
  a.plant = plant;
  const long long nb = (long long)B * a.nh_w * a.nw_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plant)
    return C == 96 && nh == 6 && ws == 8
               ? flash_tc::launch<96, 6, 8, 8, flash_tc::KEYS_MAP, true>(
                     a, nb, s)
               : (int)cudaErrorInvalidValue;
  return dispatch_tc<flash_tc::KEYS_MAP>(a, nb, ws * ws, ws * ws, C, nh, s);
}

}  // extern "C"
