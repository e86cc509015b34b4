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
// It is the Subpixel policy of the shared conv engine (conv_engine.cuh):
// the tensor-core body for bf16 inputs whose pixels are channels-last
// runs of C_in % 8 == 0 channels (EDSR's and ESPCN's heads), the direct
// body for f32 and every other layout. The GEMM's columns are taken in
// sub-pixel-major order, q = s*C_out + c with s = i*r + j, so a block that
// holds r^2*C_out consecutive columns owns whole HR rows: the tensor-core
// put writes each tile row's r HR rows as runs of TW*r*C_out contiguous
// values, in 16-byte stores when C_out % 8 == 0.
//
// Layouts. x is the model's [B, C_in, H, W] activation as it lies in
// memory, any strides (the port's convs hand it over channels-last). wk
// is the K-major matrix [9*C_in][ldw] (row tap*C_in + ci, column q,
// zero past C_out*r^2) and bias [ldw] f32 (or null), both built by the
// wrapper from the conv's OIHW weight and bias. out is [B, H*r, W*r,
// C_out], channels last. Every value is accumulated in f32, the bias
// added in f32, and stored in x's type (bf16 or f32) with one rounding.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s; ridge ~295 FLOP a
// byte): EDSR's stages (C_in 64 -> 256) do 9*64*256 MACs a pixel for
// 128 + 512 bytes, so they are bound by operations, which the tensor-core
// body targets; ESPCN's head (32 -> 16) by bytes, which the halo tile
// read once and the 16-byte stores target.

#include "conv_engine.cuh"

namespace {

using conv_engine::bf16;
using conv_engine::to_f;

// Faults the check in chip_smoke.py plants (0 in every other launch).
constexpr int PLANT_SWAP_IJ = 1;  // sub-pixel (i, j) stored at (j, i)
constexpr int PLANT_CLAMP = 2;    // border read clamped, not zero
constexpr int PLANT_NO_BIAS = 3;  // bias dropped

// The tensor-core put's work split: rows of `seg` vectors each. Threads
// take vectors u0, u0 + ustep, ... and, within each, rows r0, r0 +
// rstep, ...; false if this thread has none.
__device__ __forceinline__ bool split_rows(int seg, int tid, int& u0,
                                           int& ustep, int& r0, int& rstep) {
  if (seg >= conv_engine::tc::NTHREADS) {
    u0 = tid, ustep = conv_engine::tc::NTHREADS, r0 = 0, rstep = 1;
    return true;
  }
  rstep = conv_engine::tc::NTHREADS / seg;
  r0 = tid / seg;
  u0 = tid - r0 * seg, ustep = seg;
  return r0 < rstep;
}

template <typename T>
struct Subpixel {
  const T* x;
  long long sb, sc, sy, sx;  // x's strides in elements, NCHW order
  int B, H, W, c_in;
  const T* wk;               // [9 * c_in][ldw]
  int ldw;
  const float* bias;         // [ldw], sub-pixel-major, or null
  T* out;                    // [B][H*r][W*r][c_out]
  int c_out, r, plant;

  __host__ __device__ int cin() const { return c_in; }
  __host__ __device__ int cout() const { return c_out * r * r; }
  __host__ __device__ int y0() const { return 0; }
  __host__ __device__ int x0() const { return 0; }
  __host__ __device__ int rows() const { return H; }
  __host__ __device__ int cols_out() const { return W; }
  __device__ __forceinline__ bool drops() const { return false; }
  __device__ __forceinline__ bool skips(int) const { return false; }
  __device__ __forceinline__ bool dropped(int, int) const { return false; }

  // PLANT_CLAMP: the border read from the nearest pixel, not as zero
  __device__ __forceinline__ bool at(int& y, int& xx) const {
    if (plant == PLANT_CLAMP) {
      y = min(max(y, 0), H - 1);
      xx = min(max(xx, 0), W - 1);
    }
    return y >= 0 && y < H && xx >= 0 && xx < W;
  }
  __device__ __forceinline__ float load(int b, int y, int xx, int ci) const {
    if (!at(y, xx)) return 0.f;
    return to_f(x[b * sb + ci * sc + y * sy + xx * sx]);
  }
  __device__ __forceinline__ float weight(int tap, int ci, int q) const {
    return to_f(wk[((size_t)tap * c_in + ci) * ldw + q]);
  }
  __device__ __forceinline__ float bias_at(int q) const {
    return (bias != nullptr && plant != PLANT_NO_BIAS && q < cout()) ? bias[q]
                                                                     : 0.f;
  }
  __device__ __forceinline__ float2 finish(int, int, int, int, float v0,
                                         float v1) const {
    return make_float2(v0, v1);
  }
  // HR pixel (y*r + i, x*r + j), or (y*r + j, x*r + i) under PLANT_SWAP_IJ
  __device__ __forceinline__ size_t hr(int b, int y, int xx, int i,
                                       int j) const {
    if (plant == PLANT_SWAP_IJ) {
      const int t = i;
      i = j;
      j = t;
    }
    return (((size_t)b * H * r + (size_t)y * r + i) * W * r +
            (size_t)xx * r + j) * c_out;
  }
  __device__ __forceinline__ void put(int b, int y, int xx, int q,
                                      float acc) const {
    const int s = q / c_out, i = s / r;
    conv_engine::store(&out[hr(b, y, xx, i, s - i * r) + (q - s * c_out)],
                       acc + bias_at(q));
  }

  // tensor-core body (T = bf16, sc == 1)
  __device__ __forceinline__ const T* tc_run(int b, int y, int xx,
                                             int c) const {
    if (!at(y, xx)) return nullptr;
    return x + b * sb + y * sy + xx * sx + c;
  }
  // Each tile row's r HR rows: the segment of HR row (y*r + i) over the
  // tile's columns is TW*r*c_out contiguous values, vector u of it
  // holding HR pixel u / cv (LR column px / r, sub-pixel j = px % r) and
  // channels (u % cv) * vec. Row index row = ty*r + i.
  template <int BN>
  __device__ void tc_put(const bf16* tile, int tstr, int b, int ty0, int tx0,
                         int n0, int tid) const {
    using conv_engine::tc::TH;
    using conv_engine::tc::TW;
    const int vec = c_out % 8 == 0 ? 8 : 1;
    const int run = r * c_out;  // HR pixels (x*r + j, j < r) of one row
    if (vec == 8 && plant != PLANT_SWAP_IJ &&
        BN % run == 0) {
      for (int e = tid; e < TH * r * TW; e += conv_engine::tc::NTHREADS) {
        const int tx = e % TW, row = e / TW;
        const int ty = row / r, i = row - ty * r;
        const int y = ty0 + ty, xx = tx0 + tx, q = i * run;
        if (y < H && xx < W && q >= n0 && q < n0 + BN)
          conv_engine::bulk_store(
              out + hr(b, y, xx, i, 0),
              conv_engine::smem_u32(tile + (ty * TW + tx) * tstr + q - n0),
              run * 2);
      }
      return;
    }
    const int cv = c_out / vec;
    int u0, ustep, r0, rstep;
    if (!split_rows(TW * r * cv, tid, u0, ustep, r0, rstep))
      return;
    for (int u = u0; u < TW * r * cv; u += ustep) {
      const int px = u / cv, c = (u - px * cv) * vec;
      const int tx = px / r, j = px - tx * r;
      const int xx = tx0 + tx;
      if (xx >= W) continue;
      int ty = r0 / r, i = r0 - ty * r;
      for (int row = r0; row < TH * r; row += rstep) {
        const int y = ty0 + ty;
        if (y >= H) break;
        const int q = (i * r + j) * c_out + c;
        if (q >= n0 && q < n0 + BN) {
          const bf16* src = tile + (ty * TW + tx) * tstr + (q - n0);
          T* dst = out + hr(b, y, xx, i, j) + c;
          if (vec == 8)
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          else
            *dst = *src;
        }
        for (i += rstep; i >= r; i -= r) ++ty;
      }
    }
  }
};

}  // namespace

extern "C" {

// Kernel 15. f32: 1 for f32 tensors, 0 for bf16; tc: 1 for the
// tensor-core body (bf16, channels-last x: sc == 1), 0 for the direct
// body. x strides in elements (NCHW order); wk [9*cin][ldw] in x's type;
// bias [ldw] f32 or null; plant is 0 but in the check that plants
// faults. Returns the cudaError_t of the launch (0 on success).
int subpixel_conv3x3_d2s(const void* x, long long sb, long long sc,
                         long long sy, long long sx, int B, int H, int W,
                         int cin, const void* wk, int ldw, const float* bias,
                         int cout, int r, void* out, int f32, int tc,
                         int plant, void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin < 1 || cout < 1 || r < 1 ||
      ldw < cout * r * r || (tc && (f32 || sc != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    const Subpixel<float> a{static_cast<const float*>(x), sb, sc, sy, sx,
                            B, H, W, cin, static_cast<const float*>(wk), ldw,
                            bias, static_cast<float*>(out), cout, r, plant};
    return conv_engine::direct::launch<Subpixel<float>, false>(a, s);
  }
  const Subpixel<bf16> a{static_cast<const bf16*>(x), sb, sc, sy, sx,
                         B, H, W, cin, static_cast<const bf16*>(wk), ldw,
                         bias, static_cast<bf16*>(out), cout, r, plant};
  return tc ? conv_engine::tc::launch(a, s)
            : conv_engine::direct::launch<Subpixel<bf16>, false>(a, s);
}

}  // extern "C"
