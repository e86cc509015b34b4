// Kernel 13, the dense block's backward, on the tensor cores (sm_90a).
//
// Replaces superresolution_tpu/ops/pallas_dense_trunk_vjp.py:
// fused_dense_block_train (_bwd_kernel) together with train_kernels.cu,
// which keeps dense_scale_kernel, the fixed-order wgrad_reduce_kernel and
// the f32 FFMA forms that shapes off the route rule take
// (ops/dense_trunk.uses_tensor_cores: bf16, C and g multiples of 8,
// C + 4g <= 256). ops/dense_trunk_train.py runs, per call:
//   - the transposed convs, one per source y_4..y_1 and one into dx,
//     through the conv engine's tensor-core body (conv_engine.cuh) under
//     DenseGradConv: the input is a channel prefix of the cotangent
//     workspace D = [dacc5 | dpre4 | ... | dpre1] (n_in = C + (4 - i) g
//     channels of D's 4g + C), the weights the flipped, channel-
//     transposed K-major [9 * n_in][n_out] (flip_weights_kernel below
//     makes all five in one launch), and finish applies the lrelu' gate
//     read from the recompute workspace y (v = y > 0 ? v : 0.2 v) or,
//     for dx, adds s_id * dout; one rounding. Source i writes D's
//     channels n_in .. n_in + g of the tensor whose channels 0 .. n_in it
//     reads: disjoint, and n_in * 2 bytes keep the bulk stores 16-byte
//     aligned;
//   - wgrad_tc_kernel per conv: dW_j[tap * cin + ci][co] = sum_p
//     in_j[p + tap][ci] * dpre_j[p][co] as a GEMM with M the (tap, ci)
//     rows, N the co columns and K the pixels. A block owns CI input
//     channels x CO output channels and a chunk of pixel tiles; for each
//     8 x 16 tile it stages in_j's CI channels with a 1-pixel zero halo
//     (x and y's first (j - 1) g channels as two sources) and dpre_j's CO
//     channels, channels-last, by cp.async into a two-deep ring (the next
//     tile lands while this one's products issue). For tap (ky, kx) the
//     A operand (ci x pixels) is the halo tile's window shifted by
//     (ky, kx), read with ldmatrix.trans, so the shift is one address per
//     row; B (pixels x co) is dpre's tile, also by ldmatrix.trans. Warp
//     (ky, 16-channel fragment) holds the three kx taps x CO columns of
//     f32 sums (96 a thread at CO 64). db_j is the column sum of dpre's
//     tile, taken from the staged tile in the same pass in a fixed order.
//     Each block writes its chunk's f32 partials, and wgrad_reduce_kernel
//     sums the chunks in a fixed order: no float atomics, two calls give
//     the same bits.
// With `seg` (batch-packed rows) spacer rows are staged as zero in every
// input (so no spacer row enters dW or db) and stored as 0 by the
// transposed convs (seg_plant 1, a planted fault: not zeroed at the
// store), as the direct forms do.
//
// Bound on the H100 at hybrid_astro's [4,128,128,64] (C 64, g 32): the
// transposed convs and the weight grads each do the forward's 239,616
// MACs per pixel and the recompute 129,024, 8.0e10 FLOP a call, 0.081 ms
// at 989 TFLOP/s: bound by operations. What holds each launch back is in
// PERF.md (scripts/chain_grad_variants.py).

#include "conv_engine.cuh"

namespace {

using conv_engine::bf16;

// The transposed conv of kernel 13 (see the file's header). T is bf16 on
// the tensor-core body; f32 (a model trained under precision "fp32")
// runs the engine's direct body (direct::conv_kernel<DenseGradConv<
// float>>, f32 FFMA: the members y0 .. put), the same function in f32.
template <typename T>
struct DenseGradConv {
  const T* d;          // [B,H,W,dstr]: logical channels [0, n_in) of D
  int B, H, W, dstr, n_in;
  const T* wk;         // [9 * n_in][ldw], ldw = n
  int ldw;
  T* out;              // [B,H,W,ostride], channels out_off ..
  int ostride, out_off, n;
  const T* gate;       // or null: v = gate > 0 ? v : 0.2 v
  int gstride;
  const T* add;        // or null: v = v + add_scale * add
  int astride;
  float add_scale;
  int seg_stride, seg_valid, seg_plant;

  __host__ __device__ int cin() const { return n_in; }
  __host__ __device__ int cout() const { return n; }
  __host__ __device__ int rows() const { return H; }
  __host__ __device__ int cols_out() const { return W; }
  __device__ __forceinline__ bool drops() const { return false; }
  __device__ __forceinline__ bool skips(int) const { return false; }
  __device__ __forceinline__ bool dropped(int, int) const { return false; }

  __device__ __forceinline__ bool image_row(int y) const {
    return seg_stride == 0 || y % seg_stride < seg_valid;
  }
  __device__ __forceinline__ size_t pix(int b, int y, int xx) const {
    return ((size_t)b * H + y) * W + xx;
  }
  __device__ __forceinline__ const bf16* tc_run(int b, int y, int xx,
                                                int c) const {
    if (y < 0 || y >= H || xx < 0 || xx >= W || !image_row(y))
      return nullptr;
    return d + pix(b, y, xx) * dstr + c;
  }
  __device__ __forceinline__ float bias_at(int) const { return 0.f; }
  __device__ __forceinline__ float2 finish(int b, int y, int xx, int o,
                                           float v0, float v1) const {
    if (y >= H || xx >= W || o >= n || (!image_row(y) && !seg_plant))
      return make_float2(0.f, 0.f);
    const size_t p = pix(b, y, xx);
    if (gate != nullptr) {
      const float2 gv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(gate + p * gstride + o));
      if (!(gv.x > 0.f)) v0 *= 0.2f;
      if (!(gv.y > 0.f)) v1 *= 0.2f;
    }
    if (add != nullptr) {
      const float2 r = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(add + p * astride + o));
      v0 += add_scale * r.x, v1 += add_scale * r.y;
    }
    return make_float2(v0, v1);
  }
  // The direct body (f32): the same input, gate, add and spacer rows, one
  // channel at a time.
  __host__ __device__ int y0() const { return 0; }
  __host__ __device__ int x0() const { return 0; }
  __device__ __forceinline__ float load(int b, int y, int xx, int c) const {
    if (y < 0 || y >= H || xx < 0 || xx >= W || !image_row(y)) return 0.f;
    return conv_engine::to_f(d[pix(b, y, xx) * dstr + c]);
  }
  __device__ __forceinline__ float weight(int tap, int c, int o) const {
    return conv_engine::to_f(wk[((size_t)tap * n_in + c) * ldw + o]);
  }
  __device__ __forceinline__ void put(int b, int y, int xx, int o,
                                      float v) const {
    const size_t p = pix(b, y, xx);
    if (!image_row(y) && !seg_plant) {
      v = 0.f;
    } else {
      if (gate != nullptr && !(conv_engine::to_f(gate[p * gstride + o]) > 0.f))
        v *= 0.2f;
      if (add != nullptr) v += add_scale * conv_engine::to_f(add[p * astride + o]);
    }
    conv_engine::store(out + p * ostride + out_off + o, v);
  }
  // One bulk copy per pixel of the tile: its min(BN, n - n0) channels at
  // channel out_off + n0 (n, out_off, ostride multiples of 8).
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

// ---- the weight grads ---------------------------------------------------

namespace wg {

constexpr int TH = 8, TW = 16;          // a pixel tile: 8 k-steps of 16
constexpr int IH = TH + 2, IW = TW + 2;
constexpr int CI = 32;                  // input channels a block (dW rows:
                                        // 9 taps x CI)
constexpr int MFS = CI / 16;            // 16-row M fragments a tap
constexpr int NWARPS = 3 * MFS;         // one warp a (ky, fragment)
constexpr int NTHREADS = 32 * NWARPS;
constexpr int ISTR = CI + 8;            // staged pixel strides, padded so
                                        // an ldmatrix's 8 rows miss banks
constexpr int BLOCKS_PER_SM = 2;        // the chunk count's target

template <int CO>
constexpr size_t smem_bytes() {
  return (size_t)2 * (IH * IW * ISTR + TH * TW * (CO + 8)) * 2 +
         (size_t)NTHREADS * 4;
}

struct Args {
  // in_j = [in0 channels 0..cin0) | in1 channels 0..cin1)], NHWC.
  const bf16* in0;
  int in0_stride, cin0;
  const bf16* in1;
  int in1_stride, cin1;
  const bf16* d;           // dpre_j: channel o at d[pix * d_stride + o]
  int d_stride, cout;
  int B, H, W;
  int seg_stride, seg_valid;
  float* part_w;           // [nchunk][9][cin][cout]
  float* part_b;           // [nchunk][cout], or null
  int nchunk;
};

__device__ __forceinline__ bool image_row(const Args& a, int y) {
  return a.seg_stride == 0 || y % a.seg_stride < a.seg_valid;
}

// Grid (nchunk, ceil(cin / CI), ceil(cout / CO)). Block `chunk` walks
// pixel tiles chunk, chunk + nchunk, ... (row-major over B x tile rows x
// tile columns) and writes its partial sums of dW's rows (tap, ci0 ..
// ci0 + CI) x columns co0 .. co0 + CO, and (ci block 0) of db.
template <int CO>
__global__ void __launch_bounds__(NTHREADS)
    wgrad_tc_kernel(const Args a) {
  constexpr int NF = CO / 8, DS = CO + 8;
  constexpr int IN_E = IH * IW * ISTR, D_E = TH * TW * DS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2][in tile | d tile]
  float* bsum = reinterpret_cast<float*>(smem + 2 * (IN_E + D_E) * 2);
  const int cin = a.cin0 + a.cin1;
  const int ci0 = blockIdx.y * CI, co0 = blockIdx.z * CO;
  const int tiles_y = (a.H + TH - 1) / TH, tiles_x = (a.W + TW - 1) / TW;
  const int ntiles = a.B * tiles_y * tiles_x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ky = warp / MFS, mf = warp - ky * MFS;
  const bool do_bias = a.part_b != nullptr && blockIdx.y == 0;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  auto stage = [&](int t, int buf) {
    const int b = t / (tiles_y * tiles_x);
    const int y0 = ((t / tiles_x) % tiles_y) * TH;
    const int x0 = (t % tiles_x) * TW;
    bf16* in_s = ring + buf * (IN_E + D_E);
    bf16* d_s = in_s + IN_E;
    for (int e = tid; e < IH * IW * (CI / 8); e += NTHREADS) {
      const int pix = e / (CI / 8), v = e - pix * (CI / 8);
      const int py = pix / IW, px = pix - py * IW;
      const int gy = y0 + py - 1, gx = x0 + px - 1, c = ci0 + v * 8;
      const bf16* src = nullptr;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < cin &&
          image_row(a, gy)) {
        const size_t p = ((size_t)b * a.H + gy) * a.W + gx;
        src = c < a.cin0 ? a.in0 + p * a.in0_stride + c
                         : a.in1 + p * a.in1_stride + (c - a.cin0);
      }
      bf16* dst = in_s + pix * ISTR + v * 8;
      if (src != nullptr)
        conv_engine::cp_async16(conv_engine::smem_u32(dst), src);
      else
        *reinterpret_cast<uint4*>(dst) = zero4;
    }
    for (int e = tid; e < TH * TW * (CO / 8); e += NTHREADS) {
      const int pix = e / (CO / 8), v = e - pix * (CO / 8);
      const int py = pix / TW, px = pix - py * TW;
      const int gy = y0 + py, gx = x0 + px, o = co0 + v * 8;
      bf16* dst = d_s + pix * DS + v * 8;
      if (gy < a.H && gx < a.W && o < a.cout && image_row(a, gy))
        conv_engine::cp_async16(
            conv_engine::smem_u32(dst),
            a.d + (((size_t)b * a.H + gy) * a.W + gx) * a.d_stride + o);
      else
        *reinterpret_cast<uint4*>(dst) = zero4;
    }
  };

  float acc[3][NF][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[kx][j][q] = 0.f;
  float bacc = 0.f;
  constexpr int GROUPS = NTHREADS / CO > 0 ? NTHREADS / CO : 1;
  const int bcol = tid % CO, bgrp = tid / CO;

  // ldmatrix.trans rows: A lane l reads pixel column (l & 7) + 8 (l >> 4)
  // at channel offset 8 ((l >> 3) & 1) of its fragment; B lane l reads
  // pixel l & 15 at column 8 (l >> 4)
  const int a_px = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t a_lane =
      (uint32_t)((ky * IW + a_px) * ISTR + mf * 16 + ((lane >> 3) & 1) * 8) *
      2;
  const uint32_t b_lane = (uint32_t)((lane & 15) * DS + (lane >> 4) * 8) * 2;

  int t = blockIdx.x, buf = 0;
  if (t < ntiles) stage(t, 0);
  conv_engine::cp_async_commit();
  for (; t < ntiles; t += a.nchunk, buf ^= 1) {
    if (t + a.nchunk < ntiles) stage(t + a.nchunk, buf ^ 1);
    conv_engine::cp_async_commit();
    conv_engine::cp_async_wait<1>();
    __syncthreads();
    const bf16* in_s = ring + buf * (IN_E + D_E);
    const bf16* d_s = in_s + IN_E;
    if (do_bias && bgrp < GROUPS)
      for (int p = bgrp; p < TH * TW; p += GROUPS)
        bacc += __bfloat162float(d_s[p * DS + bcol]);
    const uint32_t a0 = conv_engine::smem_u32(in_s) + a_lane;
    const uint32_t b0 = conv_engine::smem_u32(d_s) + b_lane;
#pragma unroll 2
    for (int r = 0; r < TH; ++r) {
      uint32_t bf[NF][2];
#pragma unroll
      for (int j = 0; j < NF; j += 2) {
        uint32_t q[4];
        conv_engine::ldmatrix_x4_trans(q, b0 + (r * TW * DS + j * 8) * 2);
        bf[j][0] = q[0], bf[j][1] = q[1];
        bf[j + 1][0] = q[2], bf[j + 1][1] = q[3];
      }
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t af[4];
        conv_engine::ldmatrix_x4_trans(af, a0 + (r * IW + kx) * ISTR * 2);
#pragma unroll
        for (int j = 0; j < NF; ++j)
          conv_engine::mma_bf16(acc[kx][j], af, bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();  // the buffer is restaged next iteration
  }
  conv_engine::cp_async_wait<0>();

  // accumulator (kx, j, q): dW row (ky * 3 + kx, ci0 + mf * 16 + (lane >>
  // 2) + 8 (q >> 1)), column co0 + j * 8 + 2 (lane & 3) + (q & 1)
  const size_t nw = (size_t)9 * cin * a.cout;
  float* pw = a.part_w + (size_t)blockIdx.x * nw;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + mf * 16 + (lane >> 2) + 8 * h;
        const int co = co0 + j * 8 + 2 * (lane & 3);
        if (ci < cin && co < a.cout)
          *reinterpret_cast<float2*>(
              pw + ((size_t)(ky * 3 + kx) * cin + ci) * a.cout + co) =
              make_float2(acc[kx][j][2 * h], acc[kx][j][2 * h + 1]);
      }
  if (!do_bias) return;
  bsum[tid] = bacc;
  __syncthreads();
  if (tid < CO && co0 + tid < a.cout) {
    float s = 0.f;
    for (int g = 0; g < GROUPS; ++g) s += bsum[g * CO + tid];
    a.part_b[(size_t)blockIdx.x * a.cout + co0 + tid] = s;
  }
}

}  // namespace wg

// ---- the flipped weights ------------------------------------------------

struct FiveWeights {
  const bf16* w[5];  // conv_1..conv_5, HWIO [3,3,C + (j-1) g, g or C]
};

// out = the five transposed convs' K-major weights, source 4, 3, 2, 1,
// then 0 (x), one after another: source i's [3][3][n_in][n_src] with
// n_in = C + (4 - i) g rows in D's order (conv 5's C, then conv 4's g, ...
// down to conv i+1's) and n_src = g (C for x); element (tap, r, col) =
// W_j[8 - tap][lo_i + col][rr] for the conv j and row rr of D's channel
// r, lo_i the source's first channel in conv j's input.
__global__ void __launch_bounds__(256)
    flip_weights_kernel(const FiveWeights fw, int C, int g,
                        bf16* __restrict__ out, long long total) {
  for (long long e = (long long)blockIdx.x * 256 + threadIdx.x; e < total;
       e += (long long)gridDim.x * 256) {
    long long rem = e;
    int src = 4;
    for (; src > 0; --src) {  // sources 4..1, then 0
      const long long n = 9ll * (C + (4 - src) * g) * g;
      if (rem < n) break;
      rem -= n;
    }
    const int n_in = C + (4 - src) * g, n_src = src ? g : C;
    const int col = (int)(rem % n_src);
    const int r = (int)((rem / n_src) % n_in);
    const int tap = (int)(rem / ((long long)n_src * n_in));
    int j, rr;
    if (r < C) {
      j = 5, rr = r;
    } else {
      j = 4 - (r - C) / g, rr = (r - C) % g;
    }
    const int cin_j = C + (j - 1) * g, cout_j = j == 5 ? C : g;
    const int lo = src ? C + (src - 1) * g : 0;
    out[e] = fw.w[j - 1][((size_t)(8 - tap) * cin_j + lo + col) * cout_j + rr];
  }
}

}  // namespace

extern "C" {

int train_wgrad_reduce(const void* part, size_t nw, int cout, int nchunk,
                       int with_bias, void* dw, void* db, void* stream);

// One launch of a transposed conv of kernel 13 (DenseGradConv): out[...,
// out_off:out_off + n] = epilogue(conv3x3_SAME(d[..., :n_in], wk)) with
// the lrelu' gate of `gate` (channel stride gstride, or null) and then +
// add_scale * add (stride astride, or null). d [B,H,W,dstr], out
// [B,H,W,ostride], gate, add and wk the K-major [9 * n_in][n], all bf16
// (the tensor-core body) or, with f32 != 0, all f32 (the direct body).
// Returns the cudaError_t of the launch (0 on success).
int train_grad_conv(const void* d, int B, int H, int W, int dstr, int n_in,
                    const void* wk, void* out, int ostride, int out_off,
                    int n, const void* gate, int gstride, const void* add,
                    int astride, float add_scale, int seg_stride,
                    int seg_valid, int seg_plant, int f32, void* stream) {
  if (B < 1 || H < 1 || W < 1 || n_in < 1 || n_in > dstr || n < 1 ||
      out_off < 0 || out_off + n > ostride ||
      (seg_stride != 0 && (seg_valid < 1 || seg_valid > seg_stride)))
    return (int)cudaErrorInvalidValue;
  if (f32) {
    const DenseGradConv<float> a{
        static_cast<const float*>(d), B, H, W, dstr, n_in,
        static_cast<const float*>(wk), n, static_cast<float*>(out), ostride,
        out_off, n, static_cast<const float*>(gate), gstride,
        static_cast<const float*>(add), astride, add_scale, seg_stride,
        seg_valid, seg_plant};
    return conv_engine::direct::launch<DenseGradConv<float>, false>(
        a, static_cast<cudaStream_t>(stream));
  }
  if (dstr % 8 || n_in % 8 || n % 8 || out_off % 8 || ostride % 8 ||
      (gate != nullptr && gstride % 2) || (add != nullptr && astride % 2))
    return (int)cudaErrorInvalidValue;
  const DenseGradConv<bf16> a{static_cast<const bf16*>(d), B, H, W, dstr,
                        n_in, static_cast<const bf16*>(wk), n,
                        static_cast<bf16*>(out), ostride, out_off, n,
                        static_cast<const bf16*>(gate), gstride,
                        static_cast<const bf16*>(add), astride, add_scale,
                        seg_stride, seg_valid, seg_plant};
  return conv_engine::tc::launch(a, static_cast<cudaStream_t>(stream));
}

// Pixel chunks wgrad_tc_kernel uses for a conv of cin -> cout over B x H
// x W: about BLOCKS_PER_SM blocks an SM in all, at most one a pixel tile.
int train_wgrad_tc_chunks(int B, int H, int W, int cin, int cout) {
  int sms = 132;
  if (conv_engine::sm_count(&sms) != cudaSuccess) sms = 132;
  const int co = cout <= 32 ? 32 : 64;
  const int tiles =
      B * ((H + wg::TH - 1) / wg::TH) * ((W + wg::TW - 1) / wg::TW);
  const int per = ((cin + wg::CI - 1) / wg::CI) * ((cout + co - 1) / co);
  int n = (wg::BLOCKS_PER_SM * sms + per - 1) / per;
  if (n > tiles) n = tiles;
  return n < 1 ? 1 : n;
}

// The weight grad on the tensor cores: wgrad_tc_kernel's per-chunk f32
// partials in `part` (at least nchunk * (9 * cin * cout + cout) floats),
// then wgrad_reduce_kernel: dW [3,3,cin0+cin1,cout] bf16 and, when db is
// not null, db [cout] f32. Arguments as train_wgrad's.
int train_wgrad_tc(const void* in0, int in0_stride, int cin0, const void* in1,
                   int in1_stride, int cin1, const void* d, int d_stride,
                   int cout, int B, int H, int W, int seg_stride,
                   int seg_valid, int nchunk, void* part, void* dw, void* db,
                   void* stream) {
  const int cin = cin0 + cin1;
  if (B < 1 || H < 1 || W < 1 || nchunk < 1 || cin0 % 8 || cin1 % 8 ||
      cout % 8 || cout < 8 || in0_stride % 8 || d_stride % 8 ||
      (cin1 > 0 && (in1 == nullptr || in1_stride % 8)) ||
      (seg_stride != 0 && (seg_valid < 1 || seg_valid > seg_stride)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nw = (size_t)9 * cin * cout;
  wg::Args a;
  a.in0 = static_cast<const bf16*>(in0);
  a.in0_stride = in0_stride;
  a.cin0 = cin0;
  a.in1 = static_cast<const bf16*>(in1);
  a.in1_stride = in1_stride;
  a.cin1 = cin1;
  a.d = static_cast<const bf16*>(d);
  a.d_stride = d_stride;
  a.cout = cout;
  a.B = B;
  a.H = H;
  a.W = W;
  a.seg_stride = seg_stride;
  a.seg_valid = seg_valid;
  a.part_w = static_cast<float*>(part);
  a.part_b = db ? a.part_w + (size_t)nchunk * nw : nullptr;
  a.nchunk = nchunk;
  const dim3 grid(nchunk, (cin + wg::CI - 1) / wg::CI,
                  cout <= 32 ? 1 : (cout + 63) / 64);
  cudaError_t e;
  if (cout <= 32) {
    e = conv_engine::allow_smem<wg::wgrad_tc_kernel<32>>(
        wg::smem_bytes<32>());
    if (e != cudaSuccess) return (int)e;
    wg::wgrad_tc_kernel<32>
        <<<grid, wg::NTHREADS, wg::smem_bytes<32>(), s>>>(a);
  } else {
    e = conv_engine::allow_smem<wg::wgrad_tc_kernel<64>>(
        wg::smem_bytes<64>());
    if (e != cudaSuccess) return (int)e;
    wg::wgrad_tc_kernel<64>
        <<<grid, wg::NTHREADS, wg::smem_bytes<64>(), s>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return train_wgrad_reduce(part, nw, cout, nchunk, db != nullptr, dw, db,
                            stream);
}

// All five transposed convs' weights in one launch (flip_weights_kernel):
// w the five HWIO bf16 kernels, out bf16 with room for
// sum_i 9 * n_in_i * n_src_i elements.
int train_flip_weights(const void* const* w, int C, int g, void* out,
                       void* stream) {
  FiveWeights fw;
  for (int j = 0; j < 5; ++j) fw.w[j] = static_cast<const bf16*>(w[j]);
  long long total = 9ll * C * (C + 4 * g);
  for (int i = 1; i <= 4; ++i) total += 9ll * (C + (4 - i) * g) * g;
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  flip_weights_kernel<<<(unsigned)blocks, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fw, C, g, static_cast<bf16*>(out), total);
  return (int)cudaGetLastError();
}

}  // extern "C"
