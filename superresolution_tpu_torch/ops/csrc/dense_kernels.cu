// Hand-written CUDA kernel of the RRDB trunk's dense block (sm_90a): B1.
//
//   B1 fused_dense_block  (replaces superresolution_tpu/ops/
//      pallas_dense_trunk.py:fused_dense_block, _kernel): five launches of
//      the shared conv engine's tensor-core body (conv_engine.cuh,
//      conv_tc_kernel<DenseConv<bf16>, BN>) over one [B,H,W,4g] workspace.
//      conv_j (j < 4) stages x (C channels, source 0) and the workspace's
//      first j*g channels (source 1) as one 16-byte run per 8 logical
//      channels, and writes lrelu(acc + b) into workspace channels
//      j*g .. (j+1)*g; conv_5 stages x and all 4g and writes
//      x + 0.2 * (acc + b), then res + 0.2 * that when a residual is given.
//      SAME zero padding at every conv holds by construction: each launch
//      stages its input through a zero halo. With `seg` (batch-packed
//      rows: images stacked along H, seg_stride rows apiece, the last
//      seg_stride - seg_valid of them zero spacers) a spacer row is staged
//      as zero and stored as 0, so each image sees exact SAME padding
//      through all five convs (seg_plant 1, a planted fault: not zeroed at
//      the store).
//
// The GEMM of conv_j: M = the block's 8 x 16 output pixels, N = g (or C
// at conv_5), K = 9 taps x (C + j*g) channels in the weights' HWIO order
// (row tap * cin + ci, so the two sources follow one another along K).
// The f32 sums plus the f32 bias go through finish (lrelu, the residuals
// read per pixel in f32, the spacer rows) and are rounded to bf16 once;
// tc_put writes each pixel's N channels as one bulk copy (64 or 128
// bytes) at its channel offset in the workspace or the output.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): 239,616 MACs a
// pixel for 384 bytes of x, residual and output, so operations bound it
// (1.12 ms at [24,376,256,64]). The body issues mma.sync m16n8k16 from
// ldmatrix fragments; at N = 32 each k-step's 8 products wait on 5
// fragment loads (4 of A, 1 of B), which the variants of
// scripts/dense_tail_variants.py measure.
//
// Shapes the route rule (ops/dense_trunk.uses_tensor_cores) sends
// elsewhere (C or g not a multiple of 8, C + 4g > 256, f32) run
// sr_kernels.cu's direct conv3x3_kernel.

#include "conv_engine.cuh"

namespace {

using conv_engine::bf16;
using conv_engine::lrelu;

template <typename T>
struct DenseConv {
  const T* x;          // [B,H,W,C]: logical channels [0, C)
  const T* ws;         // [B,H,W,g4]: logical channels [C, C + cin1)
  int B, H, W, C, g4, cin1;
  const T* wk;         // [9 * (C + cin1)][ldw], HWIO, ldw = cout
  int ldw;
  const float* bias;   // [cout] or null
  T* out;              // [B,H,W,ostride], channels out_off ..
  int ostride, out_off, n;
  int act;             // 1: lrelu(v, 0.2)
  const T* xres;       // or null: v = xres + 0.2 * v ([B,H,W,C])
  const T* res;        // or null: v = res + 0.2 * v ([B,H,W,C])
  int seg_stride, seg_valid, seg_plant;

  __host__ __device__ int cin() const { return C + cin1; }
  __host__ __device__ int cout() const { return n; }
  __host__ __device__ int rows() const { return H; }
  __host__ __device__ int cols_out() const { return W; }
  __device__ __forceinline__ bool drops() const { return false; }
  __device__ __forceinline__ bool skips(int) const { return false; }
  __device__ __forceinline__ bool dropped(int, int) const { return false; }

  // False for a spacer row of a batch-packed map.
  __device__ __forceinline__ bool image_row(int y) const {
    return seg_stride == 0 || y % seg_stride < seg_valid;
  }
  __device__ __forceinline__ size_t pix(int b, int y, int xx) const {
    return ((size_t)b * H + y) * W + xx;
  }
  __device__ __forceinline__ const T* tc_run(int b, int y, int xx,
                                             int c) const {
    if (y < 0 || y >= H || xx < 0 || xx >= W || !image_row(y))
      return nullptr;
    const size_t p = pix(b, y, xx);
    return c < C ? x + p * C + c : ws + p * g4 + (c - C);
  }
  __device__ __forceinline__ float bias_at(int o) const {
    return (bias != nullptr && o < n) ? bias[o] : 0.f;
  }
  __device__ __forceinline__ float2 finish(int b, int y, int xx, int o,
                                           float v0, float v1) const {
    if (y >= H || xx >= W || o >= n || (!image_row(y) && !seg_plant))
      return make_float2(0.f, 0.f);
    if (act) v0 = lrelu(v0), v1 = lrelu(v1);
    const size_t at = pix(b, y, xx) * C + o;
    if (xres != nullptr) {
      const float2 r = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xres + at));
      v0 = r.x + 0.2f * v0, v1 = r.y + 0.2f * v1;
    }
    if (res != nullptr) {
      const float2 r = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(res + at));
      v0 = r.x + 0.2f * v0, v1 = r.y + 0.2f * v1;
    }
    return make_float2(v0, v1);
  }
  // One bulk copy per pixel of the tile: its min(BN, n - n0) channels at
  // channel out_off + n0 (every run a multiple of 16 bytes: the route
  // takes n % 8 == 0, out_off % 8 == 0, ostride % 8 == 0).
  template <int BN>
  __device__ void tc_put(const bf16* tile, int tstr, int b, int ty0, int tx0,
                         int n0, int tid) const {
    using conv_engine::tc::TH;
    using conv_engine::tc::TW;
    const int nb = min(BN, n - n0);
    for (int e = tid; e < TH * TW; e += conv_engine::tc::NTHREADS) {
      const int ty = e / TW, tx = e - ty * TW;
      const int y = ty0 + ty, xx = tx0 + tx;
      if (y < H && xx < W)
        conv_engine::bulk_store(out + pix(b, y, xx) * ostride + out_off + n0,
                                conv_engine::smem_u32(tile + e * tstr),
                                nb * 2);
    }
  }
};

}  // namespace

extern "C" {

// One launch of B1's conv through the tensor-core body: out[..., out_off:
// out_off + cout] = epilogue(conv3x3_SAME([x, ws[..., :cin1]], wk) +
// bias). x [B,H,W,C], ws [B,H,W,g4], out [B,H,W,ostride], xres / res
// [B,H,W,C] or null, all bf16; wk the HWIO [3,3,C+cin1,cout] bf16; bias
// [cout] f32 or null; act 1: lrelu. Returns the cudaError_t of the launch
// (0 on success).
int dense_conv(const void* x, const void* ws, int B, int H, int W, int C,
               int g4, int cin1, const void* wk, const float* bias,
               void* out, int ostride, int out_off, int cout, int act,
               const void* xres, const void* res, int seg_stride,
               int seg_valid, int seg_plant, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C % 8 || g4 % 8 || cin1 % 8 || cin1 < 0 ||
      cin1 > g4 || cout % 8 || cout < 8 || out_off % 8 || ostride % 8 ||
      out_off + cout > ostride || (cin1 > 0 && ws == nullptr) ||
      (seg_stride != 0 && (seg_valid < 1 || seg_valid > seg_stride)))
    return (int)cudaErrorInvalidValue;
  const DenseConv<bf16> a{
      static_cast<const bf16*>(x), static_cast<const bf16*>(ws), B, H, W, C,
      g4, cin1, static_cast<const bf16*>(wk), cout, bias,
      static_cast<bf16*>(out), ostride, out_off, cout, act,
      static_cast<const bf16*>(xres), static_cast<const bf16*>(res),
      seg_stride, seg_valid, seg_plant};
  return conv_engine::tc::launch(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
