// Kernel 16 on the shared conv engine (sm_90a): the pad-once fused dense
// block, five launches, one a stage.
//
//   16 fused_dense_block_valid  (replaces superresolution_tpu/ops/
//      pallas_dense.py:fused_dense_block_pallas, _kernel): one
//      FusedDenseBlock on an input zero-padded by 5 ONCE, its five convs
//      chained VALID. Stage j (1..5) is a 3x3 conv over the padded
//      frame's region [j, H+10-j) x [j, W+10-j), each 2 rows and 2 columns
//      narrower than the one before. Stages 1-4 write y_j =
//      lrelu(conv_j([x, y_1..y_{j-1}]) + b_j) into a [B, H+8, W+8, 4g]
//      workspace (frame pixel (r, s) at (r-1, s-1), y_j at channels
//      (j-1)g ..); stage 5 writes x + 0.2 * (conv_5(...) + b_5) over the
//      image. Outside the image the intermediates hold lrelu(bias + ...),
//      not zero: a stage reads x through the zero padding and every y_i
//      where it was computed, so nothing is masked. (B1's SAME conv would
//      zero them: that differs within 4 px of the border.) f32 sums; each
//      y_j and the output rounded once to x's type.
//
// Two bodies under one policy, DenseStage, as B1's DenseConv
// (dense_kernels.cu) carries both:
//   - the engine's tensor-core body (conv_engine.cuh conv_tc_kernel<
//     DenseStage<bf16>, BN>) for bf16 with c and g multiples of 8 and
//     c + 4g <= 256, B1's route rule (ops/dense_trunk.uses_tensor_cores).
//     Output pixel (y, x) of stage j is frame pixel (y+j, x+j): tc_run
//     gives x's runs (null outside the image: the pad) and the
//     workspace's (null only past the buffer, for a ragged tile's extra
//     reads; every pixel an in-region output reads was written by the
//     stages before). The weights are stage j's K-major [9 * (c +
//     (j-1)g)][cout_j] (row tap * cin_j + ci), gathered once from the
//     reference's projection matrices by ops/dense_valid.
//     pack_stage_weights. The epilogue (finish) applies lrelu or the
//     residual in f32 and tc_put writes each pixel's channels as one bulk
//     copy at its channel offset in the workspace or the output (16-byte
//     aligned: (j-1)g and the pixel stride 4g are multiples of 8).
//   - the engine's direct body (conv_kernel<DenseStage<T>>, f32 FFMA) for
//     f32 and the bf16 shapes that rule refuses; it reads the weights
//     in place from the projection matrices (weight()).
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the stage
// regions do 1.015x B1's MACs at [24,376,256,64], c 64, g 32 (B1: 239,616
// a pixel), for 256 bytes of x and output a pixel: bound by operations.
//
// Planted faults (`plant`, a bit mask; 0 in use), in either body:
// PLANT_SAME (the intermediates zeroed outside the image, SAME
// semantics), PLANT_NO_SCALE (the 0.2 residual scale dropped).

#include <stdint.h>

#include "conv_engine.cuh"

namespace {

using conv_engine::bf16;
using conv_engine::lrelu;
using conv_engine::to_f;

constexpr int PLANT_SAME = 1;
constexpr int PLANT_NO_SCALE = 2;

// Kernel 16, stage j (1..5), in the frame of x padded by 5.
template <typename T>
struct DenseStage {
  const T* x;           // [B, H, W, c]
  T* ws;                // [B, H+8, W+8, 4g]: frame pixel (r, s) at (r-1, s-1)
  T* out;               // [B, H, W, c], stage 5
  const T* w[5];        // direct body: wx [9c][cols[0]], w_i [9g][cols[i]]
  int cols[5];
  const T* wk;          // tc body: stage j's K-major [9 * cin()][ldw]
  int ldw;
  const float* bias;    // [4g + c]
  int B, H, W, c, g, j, plant;

  __host__ __device__ int cin() const { return c + (j - 1) * g; }
  __host__ __device__ int cout() const { return j < 5 ? g : c; }
  __host__ __device__ int y0() const { return j; }
  __host__ __device__ int x0() const { return j; }
  __host__ __device__ int rows() const { return H + 10 - 2 * j; }
  __host__ __device__ int cols_out() const { return W + 10 - 2 * j; }
  __device__ __forceinline__ bool drops() const { return false; }
  __device__ __forceinline__ bool skips(int) const { return false; }
  __device__ __forceinline__ bool dropped(int, int) const { return false; }

  __device__ __forceinline__ bool in_image(int r, int s) const {
    return r >= 5 && r < H + 5 && s >= 5 && s < W + 5;
  }
  __device__ __forceinline__ size_t ws_at(int b, int r, int s) const {
    return (((size_t)b * (H + 8) + r - 1) * (W + 8) + s - 1) * (4 * g);
  }
  __device__ __forceinline__ size_t img_at(int b, int y, int xx) const {
    return (((size_t)b * H + y) * W + xx) * c;
  }

  // ---- the tensor-core body: output pixel (y, xx) is frame (y+j, xx+j)
  __device__ __forceinline__ const T* tc_run(int b, int y, int xx,
                                             int ci) const {
    const int r = y + j, s = xx + j;
    if (ci < c)
      return in_image(r, s) ? x + img_at(b, r - 5, s - 5) + ci : nullptr;
    if (r < 1 || r > H + 8 || s < 1 || s > W + 8) return nullptr;
    return ws + ws_at(b, r, s) + (ci - c);
  }
  __device__ __forceinline__ float bias_at(int o) const {
    return o < cout() ? bias[(j - 1) * g + o] : 0.f;
  }
  __device__ __forceinline__ float2 finish(int b, int y, int xx, int o,
                                           float v0, float v1) const {
    if (y >= rows() || xx >= cols_out() || o >= cout())
      return make_float2(0.f, 0.f);
    if (j < 5) {
      if ((plant & PLANT_SAME) && !in_image(y + j, xx + j))
        return make_float2(0.f, 0.f);
      return make_float2(lrelu(v0), lrelu(v1));
    }
    const float2 r = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + img_at(b, y, xx) + o));
    const float scale = (plant & PLANT_NO_SCALE) ? 1.f : 0.2f;
    return make_float2(r.x + scale * v0, r.y + scale * v1);
  }
  // One bulk copy a pixel of the tile: its min(BN, cout - n0) channels
  // at channel (j-1)g + n0 of the workspace pixel, or n0 of the output.
  template <int BN>
  __device__ void tc_put(const bf16* tile, int tstr, int b, int ty0, int tx0,
                         int n0, int tid) const {
    using conv_engine::tc::TW;
    const int nb = min(BN, cout() - n0);
    for (int e = tid; e < conv_engine::tc::TH * TW;
         e += conv_engine::tc::NTHREADS) {
      const int ty = e / TW, tx = e - ty * TW;
      const int y = ty0 + ty, xx = tx0 + tx;
      if (y >= rows() || xx >= cols_out()) continue;
      T* dst = j < 5 ? ws + ws_at(b, y + j, xx + j) + (j - 1) * g + n0
                     : out + img_at(b, y, xx) + n0;
      conv_engine::bulk_store(dst, conv_engine::smem_u32(tile + e * tstr),
                              nb * 2);
    }
  }

  // ---- the direct body, in frame coordinates (r, s)
  __device__ __forceinline__ float load(int b, int r, int s, int ci) const {
    if (ci < c)
      return in_image(r, s) ? to_f(x[img_at(b, r - 5, s - 5) + ci]) : 0.f;
    // the guard only keeps a ragged tile's extra reads inside the buffer
    if (r < 1 || r > H + 8 || s < 1 || s > W + 8) return 0.f;
    return to_f(ws[ws_at(b, r, s) + (ci - c)]);
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
      if ((plant & PLANT_SAME) && !in_image(r, s)) v = 0.f;
      conv_engine::store(&ws[ws_at(b, r, s) + (j - 1) * g + o], v);
      return;
    }
    const size_t at = img_at(b, r - 5, s - 5) + o;
    const float scale = (plant & PLANT_NO_SCALE) ? 1.f : 0.2f;
    conv_engine::store(&out[at], to_f(x[at]) + scale * v);
  }
};

template <typename T>
DenseStage<T> stage(const void* x, void* ws, void* out, int B, int H, int W,
                    int c, int g, int j, const float* bias, int plant) {
  DenseStage<T> a{};
  a.x = static_cast<const T*>(x);
  a.ws = static_cast<T*>(ws);
  a.out = static_cast<T*>(out);
  a.bias = bias;
  a.B = B, a.H = H, a.W = W, a.c = c, a.g = g, a.j = j, a.plant = plant;
  return a;
}

}  // namespace

extern "C" {

// Kernel 16, stage j (1..5), on the engine's direct body. f32: 1 for f32
// tensors, 0 for bf16 (x, ws, out and the five projection matrices in
// that type; bias f32). w: the five matrix pointers (wx, w1..w4). Returns
// the cudaError_t of the launch.
int dense_valid_stage(const void* x, void* ws, void* out,
                      const void* const* w, const float* bias, int B, int H,
                      int W, int c, int g, int j, int f32, int plant,
                      void* stream) {
  if (B < 1 || H < 1 || W < 1 || c < 1 || g < 1 || j < 1 || j > 5)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols[5] = {4 * g + c, 3 * g + c, 2 * g + c, g + c, c};
  if (f32) {
    auto a = stage<float>(x, ws, out, B, H, W, c, g, j, bias, plant);
    for (int i = 0; i < 5; ++i) {
      a.w[i] = static_cast<const float*>(w[i]);
      a.cols[i] = cols[i];
    }
    return conv_engine::direct::launch<DenseStage<float>, false>(a, s);
  }
  auto a = stage<bf16>(x, ws, out, B, H, W, c, g, j, bias, plant);
  for (int i = 0; i < 5; ++i) {
    a.w[i] = static_cast<const bf16*>(w[i]);
    a.cols[i] = cols[i];
  }
  return conv_engine::direct::launch<DenseStage<bf16>, false>(a, s);
}

// Kernel 16, stage j (1..5), on the engine's tensor-core body: x, ws, out
// bf16 (c, g multiples of 8, c + 4g <= 256); wk stage j's K-major bf16
// weights [9 * (c + (j-1)g)][j < 5 ? g : c] (ops/dense_valid.
// pack_stage_weights); bias [4g + c] f32. Returns the cudaError_t of the
// launch.
int dense_valid_stage_tc(const void* x, void* ws, void* out, const void* wk,
                         const float* bias, int B, int H, int W, int c,
                         int g, int j, int plant, void* stream) {
  if (B < 1 || H < 1 || W < 1 || c < 8 || g < 8 || c % 8 || g % 8 ||
      c + 4 * g > conv_engine::tc::MAX_CIN || j < 1 || j > 5)
    return (int)cudaErrorInvalidValue;
  auto a = stage<bf16>(x, ws, out, B, H, W, c, g, j, bias, plant);
  a.wk = static_cast<const bf16*>(wk);
  a.ldw = a.cout();
  return conv_engine::tc::launch(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
