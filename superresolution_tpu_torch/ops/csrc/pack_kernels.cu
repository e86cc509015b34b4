// Hand-written CUDA kernel of the reference's pack_conv3x3 (sm_90a). No
// path of the system runs it; it is its own public op. (Kernels 16 and
// 17, built beside it, are in extra_kernels.cu.)
//
//   18 pack_conv3x3  (replaces ops/pallas_pairconv.py:pack_conv3x3,
//      _kernel): a SAME 3x3 conv (+ f32 bias, optional lrelu 0.2) on the
//      W-packed layout [B, H, W2, p*c], which is the unpacked [B, H,
//      W2*p, c] in memory. One launch of the shared engine with the
//      PackConv policy: the tensor-core body for bf16 with c % 8 == 0 and
//      n % 8 == 0, the direct body otherwise. Rows outside the image read
//      as zero, columns are read as they lie, pad packs included (as the
//      TPU kernel's taps read them), and every output column outside the
//      real pixels [p, p + width) is written as 0 so calls chain. The TPU
//      kernel's banded pack GEMMs and rolls exist for the MXU's 128-deep
//      contraction; here the pack is only an address, and the GEMM is M =
//      the unpacked pixels, N = n, K = 9 c.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at the dense
// block's widths (9 c n MACs per pixel for 2 (c + n) bytes) by
// operations. In bf16 it runs on the tensor cores (mma.sync, 989 TFLOP/s
// peak), in f32 on the CUDA cores in FFMA (67 TFLOP/s).

#include <stdint.h>

#include "conv_engine.cuh"

namespace {

using conv_engine::bf16;
using conv_engine::lrelu;
using conv_engine::store;
using conv_engine::to_f;

// Faults the checks in chip_smoke.py plant (0 in every other launch).
constexpr int PLANT_PAD_KEPT = 1;    // 18: pad packs not zeroed
constexpr int PLANT_DROP_CROSS = 2;  // 18: the left tap across a pack
                                     //     edge dropped

// Kernel 18 on the unpacked view [B, H, Wp = W2*p, c] of xp.
template <typename T>
struct PackConv {
  const T* x;           // [B, H, Wp, c]
  const T* wk;          // [3][3][c][n], HWIO = K-major [9c][ldw = n]
  int ldw;
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
    return to_f(wk[((size_t)tap * c + ci) * ldw + o]);
  }
  __device__ __forceinline__ float bias_at(int o) const {
    return o < n ? bias[o] : 0.f;
  }
  // the optional lrelu; 0 on every pad-pack column (PLANT_PAD_KEPT: not)
  __device__ __forceinline__ float value(int xx, float v) const {
    if (!((xx >= p && xx < p + width) || (plant & PLANT_PAD_KEPT))) return 0.f;
    return act ? lrelu(v) : v;
  }
  __device__ __forceinline__ float2 finish(int, int, int xx, int, float v0,
                                           float v1) const {
    return make_float2(value(xx, v0), value(xx, v1));
  }
  __device__ __forceinline__ void put(int b, int y, int xx, int o,
                                      float acc) const {
    store(&out[(((size_t)b * H + y) * Wp + xx) * n + o],
          value(xx, acc + bias_at(o)));
  }
  // PLANT_DROP_CROSS: the first pixel of each pack loses its left tap (in
  // the tensor-core body, a masked A row at kx = 0)
  __device__ __forceinline__ bool drops() const {
    return plant & PLANT_DROP_CROSS;
  }
  __device__ __forceinline__ bool dropped(int xx, int kx) const {
    return kx == 0 && xx % p == 0;
  }
  // a tile wholly in pad packs (the right pad of a 16-aligned W2) is 0
  __device__ __forceinline__ bool skips(int tx0) const {
    return !(plant & PLANT_PAD_KEPT) &&
           (tx0 >= p + width || tx0 + conv_engine::tc::TW <= p);
  }

  // tensor-core body (T = bf16)
  __device__ __forceinline__ const T* tc_run(int b, int y, int xx,
                                             int ch) const {
    if (y < 0 || y >= H || xx < 0 || xx >= Wp) return nullptr;
    return x + (((size_t)b * H + y) * Wp + xx) * c + ch;
  }
  // One bulk copy per pixel of the tile: its nb = min(BN, n - n0)
  // columns, contiguous in the output (the tensor-core route takes n % 8
  // == 0, so every run is a multiple of 16 bytes).
  template <int BN>
  __device__ void tc_put(const bf16* tile, int tstr, int b, int ty0, int tx0,
                         int n0, int tid) const {
    using conv_engine::tc::TH;
    using conv_engine::tc::TW;
    const int nb = min(BN, n - n0);
    for (int e = tid; e < TH * TW; e += conv_engine::tc::NTHREADS) {
      const int ty = e / TW, tx = e - ty * TW;
      const int y = ty0 + ty, xx = tx0 + tx;
      if (y < H && xx < Wp)
        conv_engine::bulk_store(
            out + (((size_t)b * H + y) * Wp + xx) * n + n0,
            conv_engine::smem_u32(tile + e * tstr), nb * 2);
    }
  }
};

}  // namespace

extern "C" {

// Kernel 18. xp viewed as [B, H, Wp, c], out [B, H, Wp, n], w [9c][n] in
// the same type (f32: 1 for f32), bias [n] f32; real columns [p, p +
// width); act 1: lrelu(0.2); tc: 1 for the tensor-core body (bf16, c % 8
// == 0, n % 8 == 0), 0 for the direct body.
int extra_pack_conv(const void* x, const void* w, const float* bias,
                    void* out, int B, int H, int Wp, int c, int n, int p,
                    int width, int act, int f32, int tc, int plant,
                    void* stream) {
  if (B < 1 || H < 1 || c < 1 || n < 1 || p < 1 || width < 1 ||
      p + width > Wp || (tc && (f32 || n % 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = plant & PLANT_DROP_CROSS;
  if (f32) {
    const PackConv<float> a{static_cast<const float*>(x),
                            static_cast<const float*>(w), n, bias,
                            static_cast<float*>(out), B, H, Wp, c, n, p,
                            width, act, plant};
    return drop ? conv_engine::direct::launch<PackConv<float>, true>(a, s)
                : conv_engine::direct::launch<PackConv<float>, false>(a, s);
  }
  const PackConv<bf16> a{static_cast<const bf16*>(x),
                         static_cast<const bf16*>(w), n, bias,
                         static_cast<bf16*>(out), B, H, Wp, c, n, p, width,
                         act, plant};
  if (tc) return conv_engine::tc::launch(a, s);
  return drop ? conv_engine::direct::launch<PackConv<bf16>, true>(a, s)
              : conv_engine::direct::launch<PackConv<bf16>, false>(a, s);
}

}  // extern "C"
