// Hand-written CUDA kernel of the x4 tail's up-convs (sm_90a): B2.
//
//   B2 up2_hr  (replaces superresolution_tpu/ops/pallas_phase_tail.py:
//      _run_up2hr, _up2hr_kernel): two launches of the shared conv
//      engine (conv_engine.cuh) under the PhaseUp policy, each a 3x3 SAME
//      conv with bias and lrelu read through the depth_to_space(2) view of
//      its input:
//        t = lrelu(conv_up2(d2s(z1, 2)) + b)     [B, 2H, 2W, 4c]
//        y = lrelu(conv_hr(d2s(t, 2)) + b)       [B, 4H, 4W, c]
//      (B3, conv_last, which y feeds, is stream_kernels.cu's.)
//
// Layout. d2s(z, 2) takes logical channel f of pixel (Y, X) from channel
// f * 4 + p of z's pixel (Y / 2, X / 2), p = (Y & 1) * 2 + (X & 1): the c
// channels of one output pixel lie 4 apart, and the tensor-core body
// stages 16-byte runs of 8 channels. So both inputs are held phase-major:
// channel p * c + f carries channel f * 4 + p, and a pixel's c logical
// channels are one contiguous run at p * c. z1 comes so from the model's
// conv_up1, whose output channels the caller permutes once
// (infer/phase_tail.make_phase_tail), and t from conv_up2, whose output
// columns and bias are permuted the same way once (ops/phase_tail.
// phase_major_up2); lrelu commutes with the permutation. Out-of-frame
// pixels read as zero, which is conv_hr's SAME padding at 2x and 4x.
//
// Two bodies, one policy: the tensor-core body (bf16 implicit GEMM on
// mma.sync, c % 8 == 0) for the model's widths, the direct f32-FFMA body
// for every other c (the route rule is ops/phase_tail.uses_tensor_cores).
// f32 sums, the f32 bias and lrelu, one rounding to bf16; the tensor-core
// put writes each pixel's channels as one bulk copy.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 1.18 M MACs per LR
// pixel (4 x 9*64*256 at 2x, then 16 x 9*64*64 at 4x) for 2.5 KB (z1
// in, the 4x map out), so operations bound it (1.84 ms at z1
// [8,376,256,256]). conv_up2 runs at N = 256 (two 128-column blocks a
// tile), conv_hr at N = 64.

#include "conv_engine.cuh"

namespace {

using conv_engine::bf16;
using conv_engine::lrelu;
using conv_engine::to_f;

// Faults the check in chip_smoke.py plants (0 in every other launch).
constexpr int PLANT_SWAP_PHASE = 1;  // sub-pixel (Y & 1, X & 1) read swapped
constexpr int PLANT_CLAMP = 2;       // border read clamped, not zero
constexpr int PLANT_NO_BIAS = 3;     // bias dropped

template <typename T>
struct PhaseUp {
  const T* z;          // [B, h, w, 4c], phase-major
  int B, h, w, c;
  const T* wk;         // [9 * c][ldw], HWIO
  int ldw;
  const float* bias;   // [n] or null
  T* out;              // [B, 2h, 2w, n]
  int n, plant;

  __host__ __device__ int cin() const { return c; }
  __host__ __device__ int cout() const { return n; }
  __host__ __device__ int y0() const { return 0; }
  __host__ __device__ int x0() const { return 0; }
  __host__ __device__ int rows() const { return 2 * h; }
  __host__ __device__ int cols_out() const { return 2 * w; }
  __device__ __forceinline__ bool drops() const { return false; }
  __device__ __forceinline__ bool skips(int) const { return false; }
  __device__ __forceinline__ bool dropped(int, int) const { return false; }

  // The first of the c channels of logical pixel (Y, X) in z, or null
  // outside the frame (PLANT_CLAMP: the nearest border pixel's).
  __device__ __forceinline__ const T* run(int b, int y, int xx) const {
    if (plant == PLANT_CLAMP) {
      y = min(max(y, 0), 2 * h - 1);
      xx = min(max(xx, 0), 2 * w - 1);
    }
    if (y < 0 || y >= 2 * h || xx < 0 || xx >= 2 * w) return nullptr;
    const int p = plant == PLANT_SWAP_PHASE ? (xx & 1) * 2 + (y & 1)
                                            : (y & 1) * 2 + (xx & 1);
    return z + (((size_t)b * h + (y >> 1)) * w + (xx >> 1)) * 4 * c + p * c;
  }
  __device__ __forceinline__ float load(int b, int y, int xx, int ci) const {
    const T* r = run(b, y, xx);
    return r == nullptr ? 0.f : to_f(r[ci]);
  }
  __device__ __forceinline__ float weight(int tap, int ci, int o) const {
    return to_f(wk[((size_t)tap * c + ci) * ldw + o]);
  }
  __device__ __forceinline__ float bias_at(int o) const {
    return (bias != nullptr && plant != PLANT_NO_BIAS && o < n) ? bias[o]
                                                                : 0.f;
  }
  __device__ __forceinline__ size_t at(int b, int y, int xx) const {
    return (((size_t)b * 2 * h + y) * 2 * w + xx) * n;
  }
  __device__ __forceinline__ void put(int b, int y, int xx, int o,
                                      float acc) const {
    conv_engine::store(&out[at(b, y, xx) + o], lrelu(acc + bias_at(o)));
  }

  // tensor-core body (T = bf16, c % 8 == 0, n % 8 == 0)
  __device__ __forceinline__ const T* tc_run(int b, int y, int xx,
                                             int ch) const {
    const T* r = run(b, y, xx);
    return r == nullptr ? nullptr : r + ch;
  }
  __device__ __forceinline__ float2 finish(int, int, int, int, float v0,
                                           float v1) const {
    return make_float2(lrelu(v0), lrelu(v1));
  }
  // One bulk copy per pixel of the tile: its min(BN, n - n0) channels.
  template <int BN>
  __device__ void tc_put(const bf16* tile, int tstr, int b, int ty0, int tx0,
                         int n0, int tid) const {
    using conv_engine::tc::TH;
    using conv_engine::tc::TW;
    const int nb = min(BN, n - n0);
    for (int e = tid; e < TH * TW; e += conv_engine::tc::NTHREADS) {
      const int ty = e / TW, tx = e - ty * TW;
      const int y = ty0 + ty, xx = tx0 + tx;
      if (y < 2 * h && xx < 2 * w)
        conv_engine::bulk_store(out + at(b, y, xx) + n0,
                                conv_engine::smem_u32(tile + e * tstr),
                                nb * 2);
    }
  }
};

}  // namespace

extern "C" {

// One of B2's launches: out [B, 2h, 2w, n] = lrelu(conv3x3_SAME(d2s(z,
// 2), wk) + bias) for z [B, h, w, 4c] phase-major, wk the HWIO [3,3,c,n]
// (ldw = n), bias [n] f32 or null, all else bf16. tc: 1 for the
// tensor-core body (c % 8 == 0, n % 8 == 0), 0 for the direct body; plant
// is 0 but in the check that plants faults. Returns the cudaError_t of
// the launch (0 on success).
int tail_up_conv(const void* z, int B, int h, int w, int c, const void* wk,
                 const float* bias, void* out, int n, int tc, int plant,
                 void* stream) {
  if (B < 1 || h < 1 || w < 1 || c < 1 || n < 1 ||
      (tc && (c % 8 || n % 8)))
    return (int)cudaErrorInvalidValue;
  const PhaseUp<bf16> a{static_cast<const bf16*>(z), B, h, w, c,
                        static_cast<const bf16*>(wk), n, bias,
                        static_cast<bf16*>(out), n, plant};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tc ? conv_engine::tc::launch(a, s)
            : conv_engine::direct::launch<PhaseUp<bf16>, false>(a, s);
}

}  // extern "C"
