// Hand-written CUDA kernels of the RRDB trunk's dense blocks (sm_90a): B1,
// kernels 4 and 5 (the trunk's end folds) and kernel 6.
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
//      through all five convs (PLANT_SPACER_KEPT, a planted fault: not
//      zeroed at the store).
//
//   4 fused_dense_block_prologue  (replaces superresolution_tpu/ops/
//      pallas_dense_trunk.py:fused_dense_block_prologue): head =
//      conv_first(x_raw), out = B1(head), as six launches. conv_first reads
//      x_raw of any Cin (3 for RGB, 4, 12 or 48 after a pixel unshuffle),
//      whose pixels are not the 16-byte runs of 8 channels the tensor-core
//      body stages, so it is dense_first_conv: DenseConv<bf16> with one
//      source on the engine's direct body (f32 FFMA, load zero outside the
//      frame, put rounds head to bf16 once), not a glue pass that pads
//      x_raw to 8 channels. At Cin 3 it does 1,728 MACs a pixel for 6
//      bytes in and 128 out: bound by its bytes. Then B1's five
//      tensor-core launches on head.
//   5 fused_dense_block_epilogue  (replaces pallas_dense_trunk.py:
//      fused_dense_block_epilogue): trunk_conv(residual + 0.2 * B1(x)) +
//      head, as six tensor-core launches: B1's five with the residual
//      write feat, then trunk_conv is DenseConv reading feat alone (cin1
//      0, 36,864 MACs a pixel) with the `add` term of its epilogue, v + head
//      at scale 1 after the (absent) residuals, so B1's launches, which
//      pass no add, keep their bits.
//   The sequences are ops/dense_trunk.prologue_launches and
//   epilogue_launches; at the shapes B1's route rule sends off the tensor
//   cores kernels 4 and 5 stay sr_kernels.cu's conv_chain_kernel.
//
//   6 fused_rrdb  (replaces superresolution_tpu/ops/pallas_dense_trunk.py:
//      fused_rrdb, _rrdb_kernel): one whole RRDB, b1 = B1(x), b2 = B1(b1),
//      out = x + 0.2 * B1(b2), as ONE cooperative launch of rrdb_tc_kernel:
//      persistent blocks walk the fifteen convs as stages, each stage's
//      tiles through the engine's tile body (DenseConv, B1's policy: the
//      same GEMM, epilogue and rounding as B1's launches, so B1's bits),
//      with a grid-wide barrier between stages. Convs 1-4 take 8 x 16
//      pixel tiles of 32 columns (the 4 x 1 warp grid), conv 5 4 x 16
//      tiles of 64 columns, any width by column blocks: the dynamic
//      shared memory is the largest stage's, and conv 5's 8-row tile (a
//      halo tile of C + 4g channels, ~100 KB at C 64, g 32) would hold
//      every stage to two blocks an SM where B1's convs 1-4 run three.
//      Before each barrier every thread waits until its bulk stores have
//      been written (not only read from shared memory) and fences the
//      async proxy, so the next stage's halo reads see them.
//      `out` holds b1 until block 3 overwrites it; the [B,H,W,4g]
//      workspace serves all three blocks. A block takes one tile at a
//      time through the engine's tile body, as B1's blocks do: staging
//      the next tile's halo during this tile's epilogue (the output tile
//      over the weight ring) measured within the spread (+-3%,
//      scripts/chain_grad_variants.py k6_overlap), so the simpler
//      one-tile-at-a-time form is kept.
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
// (1.12 ms at [24,376,256,64]; kernel 6 three times that, 3.36 ms). The
// body issues mma.sync m16n8k16 from ldmatrix fragments; at N = 32 each
// k-step's 8 products wait on 5 fragment loads (4 of A, 1 of B), which
// the variants of scripts/dense_tail_variants.py measure (kernel 6's,
// scripts/chain_grad_variants.py).
//
// f32 activations (a model trained under precision "fp32") run B1's five
// convs through the engine's direct body under the same policy
// (conv_engine.cuh direct::conv_kernel<DenseConv<float>>, f32 FFMA: the
// members y0 .. put below), the same function in f32 with no rounding.
// Other shapes the route rule (ops/dense_trunk.uses_tensor_cores) sends
// off the tensor cores (bf16 with C or g not a multiple of 8, C + 4g >
// 256) run sr_kernels.cu's direct conv3x3_kernel (B1) and
// conv_chain_kernel (6).

#include <cooperative_groups.h>

#include "conv_engine.cuh"

namespace {

using conv_engine::bf16;
using conv_engine::lrelu;

// Faults a check plants in DenseConv's launches (`plant`, a bit mask; 0
// in use): a spacer row of a batch-packed map left as computed at the
// store; the direct body's halo read from the nearest border pixel, not
// zero (kernel 4's conv_first).
enum { PLANT_SPACER_KEPT = 1, PLANT_HALO_CLAMPED = 2 };

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
  const T* add;        // or null: v = v + add ([B,H,W,C]; kernel 5)
  int seg_stride, seg_valid;
  int plant;           // planted faults, a bit mask (0 in use)

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
    if (y >= H || xx >= W || o >= n ||
        (!image_row(y) && !(plant & PLANT_SPACER_KEPT)))
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
    if (add != nullptr) {
      const float2 r = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(add + at));
      v0 += r.x, v1 += r.y;
    }
    return make_float2(v0, v1);
  }
  // The direct body (f32): the same staging, epilogue and spacer rows,
  // one channel at a time.
  __host__ __device__ int y0() const { return 0; }
  __host__ __device__ int x0() const { return 0; }
  __device__ __forceinline__ float load(int b, int y, int xx, int c) const {
    if (plant & PLANT_HALO_CLAMPED)
      y = min(max(y, 0), H - 1), xx = min(max(xx, 0), W - 1);
    if (y < 0 || y >= H || xx < 0 || xx >= W || !image_row(y)) return 0.f;
    const size_t p = pix(b, y, xx);
    return conv_engine::to_f(c < C ? x[p * C + c] : ws[p * g4 + (c - C)]);
  }
  __device__ __forceinline__ float weight(int tap, int c, int o) const {
    return conv_engine::to_f(wk[((size_t)tap * cin() + c) * ldw + o]);
  }
  __device__ __forceinline__ void put(int b, int y, int xx, int o,
                                      float acc) const {
    float v = 0.f;
    if (image_row(y) || (plant & PLANT_SPACER_KEPT)) {
      v = acc + bias_at(o);
      if (act) v = lrelu(v);
      const size_t at = pix(b, y, xx) * C + o;
      if (xres != nullptr) v = conv_engine::to_f(xres[at]) + 0.2f * v;
      if (res != nullptr) v = conv_engine::to_f(res[at]) + 0.2f * v;
      if (add != nullptr) v += conv_engine::to_f(add[at]);
    }
    conv_engine::store(out + pix(b, y, xx) * ostride + out_off + o, v);
  }
  // One bulk copy per pixel of the tile: its min(BN, n - n0) channels at
  // channel out_off + n0 (every run a multiple of 16 bytes: the route
  // takes n % 8 == 0, out_off % 8 == 0, ostride % 8 == 0).
  // ROWS: the tile's rows (kernel 6's conv 5 stage takes 4).
  template <int BN, int ROWS = conv_engine::tc::TH>
  __device__ void tc_put(const bf16* tile, int tstr, int b, int ty0, int tx0,
                         int n0, int tid) const {
    using conv_engine::tc::TW;
    const int nb = min(BN, n - n0);
    for (int e = tid; e < ROWS * TW; e += conv_engine::tc::NTHREADS) {
      const int ty = e / TW, tx = e - ty * TW;
      const int y = ty0 + ty, xx = tx0 + tx;
      if (y < H && xx < W)
        conv_engine::bulk_store(out + pix(b, y, xx) * ostride + out_off + n0,
                                conv_engine::smem_u32(tile + e * tstr),
                                nb * 2);
    }
  }
};

// ---- kernel 6: the whole RRDB in one cooperative launch ------------

constexpr int RRDB_STAGES = 15;
constexpr int RRDB_BN_G = 32;   // convs 1-4: 32-column tiles
constexpr int RRDB_BN_C = 64;   // conv 5: 64-column tiles of
constexpr int RRDB_TH_C = 4;    // 4 rows, so its ~71 KB (C 64, g 32) let
                                // three blocks share an SM, as B1's
                                // convs 1-4 run (8 rows: ~100 KB, two)
constexpr int RRDB_MIN_BLOCKS = RRDB_TH_C < 8 ? 3 : 2;

struct RrdbArgs {
  DenseConv<bf16> st[RRDB_STAGES];
  int plant;
};
static_assert(sizeof(RrdbArgs) <= 4096, "kernel parameters are 4 KB");

// The fault a check plants in kernel 6 (plant is 0 in use), beside
// sr_kernels.cu launch_chain's 1 (the last residual dropped) and 2 (the
// first two stages swapped): no grid barrier between stages.
enum { RRDB_PLANT_NO_BARRIER = 4 };

// Waits until this thread's bulk stores have been written to global
// memory, then orders them before the generic proxy's later accesses.
__device__ __forceinline__ void bulk_wait_written() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// One stage: the block's tiles t = blockIdx.x, + gridDim.x, ... of conv
// a, BN-column tiles.
template <int BN, int ROWS>
__device__ __forceinline__ void rrdb_stage(const DenseConv<bf16>& a,
                                           unsigned char* smem) {
  namespace tc = conv_engine::tc;
  const int tiles = tc::tile_count<BN, ROWS>(a);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    tc::tile_body<DenseConv<bf16>, BN, ROWS>(a, t, smem);
    __syncthreads();  // every bulk copy has read the tile: restage
  }
}

__global__ void __launch_bounds__(conv_engine::tc::NTHREADS, RRDB_MIN_BLOCKS)
    rrdb_tc_kernel(const RrdbArgs c) {
  extern __shared__ __align__(128) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int s = 0; s < RRDB_STAGES; ++s) {
    if (s % 5 < 4)
      rrdb_stage<RRDB_BN_G, conv_engine::tc::TH>(c.st[s], smem);
    else
      rrdb_stage<RRDB_BN_C, RRDB_TH_C>(c.st[s], smem);
    if (s + 1 == RRDB_STAGES) break;
    bulk_wait_written();
    if (!(c.plant & RRDB_PLANT_NO_BARRIER)) grid.sync();
  }
}

// The five stages of one dense block on x, as B1's five launches.
void rrdb_block(RrdbArgs& c, int first, const bf16* x, bf16* ws, bf16* out,
                const bf16* res, const void* const* w,
                const void* const* bias, int B, int H, int W, int C, int g) {
  for (int j = 0; j < 5; ++j) {
    const bool last = j == 4;
    c.st[first + j] = DenseConv<bf16>{
        x, ws, B, H, W, C, 4 * g, j * g, static_cast<const bf16*>(w[j]),
        last ? C : g, static_cast<const float*>(bias[j]),
        last ? out : ws, last ? C : 4 * g, last ? 0 : j * g,
        last ? C : g, last ? 0 : 1, last ? x : nullptr,
        last ? res : nullptr, nullptr, 0, 0, 0};
  }
}

size_t rrdb_smem(int C, int g) {
  namespace tc = conv_engine::tc;
  size_t m = tc::smem_bytes<RRDB_BN_C, RRDB_TH_C>(C + 4 * g);
  for (int j = 0; j < 4; ++j) {
    const size_t b = tc::smem_bytes<RRDB_BN_G>(C + j * g);
    if (b > m) m = b;
  }
  return m;
}

}  // namespace

extern "C" {

// One launch of B1's conv: out[..., out_off:out_off + cout] =
// epilogue(conv3x3_SAME([x, ws[..., :cin1]], wk) + bias). x [B,H,W,C],
// ws [B,H,W,g4], out [B,H,W,ostride], xres / res [B,H,W,C] or null, all
// bf16 (the tensor-core body) or, with f32 != 0, all f32 (the direct
// body); wk the HWIO [3,3,C+cin1,cout] in their type; bias [cout] f32 or
// null; act 1: lrelu. Returns the cudaError_t of the launch (0 on
// success).
int dense_conv(const void* x, const void* ws, int B, int H, int W, int C,
               int g4, int cin1, const void* wk, const float* bias,
               void* out, int ostride, int out_off, int cout, int act,
               const void* xres, const void* res, const void* add,
               int seg_stride, int seg_valid, int seg_plant, int f32,
               void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || cin1 < 0 || cin1 > g4 ||
      cout < 1 || out_off < 0 || out_off + cout > ostride ||
      (cin1 > 0 && ws == nullptr) ||
      (seg_stride != 0 && (seg_valid < 1 || seg_valid > seg_stride)))
    return (int)cudaErrorInvalidValue;
  if (f32) {
    const DenseConv<float> a{
        static_cast<const float*>(x), static_cast<const float*>(ws), B, H, W,
        C, g4, cin1, static_cast<const float*>(wk), cout, bias,
        static_cast<float*>(out), ostride, out_off, cout, act,
        static_cast<const float*>(xres), static_cast<const float*>(res),
        static_cast<const float*>(add), seg_stride, seg_valid,
        seg_plant ? PLANT_SPACER_KEPT : 0};
    return conv_engine::direct::launch<DenseConv<float>, false>(
        a, static_cast<cudaStream_t>(stream));
  }
  if (C % 8 || g4 % 8 || cin1 % 8 || cout % 8 || cout < 8 || out_off % 8 ||
      ostride % 8)
    return (int)cudaErrorInvalidValue;
  const DenseConv<bf16> a{
      static_cast<const bf16*>(x), static_cast<const bf16*>(ws), B, H, W, C,
      g4, cin1, static_cast<const bf16*>(wk), cout, bias,
      static_cast<bf16*>(out), ostride, out_off, cout, act,
      static_cast<const bf16*>(xres), static_cast<const bf16*>(res),
      static_cast<const bf16*>(add), seg_stride, seg_valid,
      seg_plant ? PLANT_SPACER_KEPT : 0};
  return conv_engine::tc::launch(a, static_cast<cudaStream_t>(stream));
}

// Kernel 4's conv_first on the engine's direct body (DenseConv<bf16> with
// one source of any cin, f32 FFMA): out [B,H,W,cout] = conv3x3_SAME(x_raw,
// wk) + bias, one rounding to bf16. x_raw [B,H,W,cin] and wk, the HWIO
// [3,3,cin,cout], bf16; bias [cout] f32. clamp_halo != 0 plants
// PLANT_HALO_CLAMPED. Returns the cudaError_t of the launch (0 on
// success).
int dense_first_conv(const void* x_raw, int B, int H, int W, int cin,
                     const void* wk, const float* bias, void* out, int cout,
                     int clamp_halo, void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  const DenseConv<bf16> a{
      static_cast<const bf16*>(x_raw), nullptr, B, H, W, cin, 0, 0,
      static_cast<const bf16*>(wk), cout, bias, static_cast<bf16*>(out),
      cout, 0, cout, 0, nullptr, nullptr, nullptr, 0, 0,
      clamp_halo ? PLANT_HALO_CLAMPED : 0};
  return conv_engine::direct::launch<DenseConv<bf16>, false, 32>(
      a, static_cast<cudaStream_t>(stream));
}

// Kernel 6: one RRDB, one cooperative launch of rrdb_tc_kernel: b1 =
// block(x) into out, b2 = block(b1) into tmp, out = x + 0.2 * block(b2).
// x, tmp, out [B,H,W,C] and ws [B,H,W,4g] bf16; w, bias: 15 pointers each
// (three blocks of five HWIO bf16 kernels, f32 biases). plant: 0 in use.
// Returns the cudaError_t of the launch (0 on success).
int dense_rrdb(const void* x, const void* const* w, const void* const* bias,
               void* ws, void* tmp, void* out, int B, int H, int W, int C,
               int g, int plant, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C % 8 || g % 8 || C < 8 || g < 8 ||
      C + 4 * g > conv_engine::tc::MAX_CIN)
    return (int)cudaErrorInvalidValue;
  RrdbArgs c = {};
  const bf16* xi = static_cast<const bf16*>(x);
  bf16* wk = static_cast<bf16*>(ws);
  bf16* t = static_cast<bf16*>(tmp);
  bf16* o = static_cast<bf16*>(out);
  rrdb_block(c, 0, xi, wk, o, nullptr, w, bias, B, H, W, C, g);
  rrdb_block(c, 5, o, wk, t, nullptr, w + 5, bias + 5, B, H, W, C, g);
  rrdb_block(c, 10, t, wk, o, xi, w + 10, bias + 10, B, H, W, C, g);
  if (plant & 1) c.st[RRDB_STAGES - 1].res = nullptr;  // as launch_chain's
  if (plant & 2) {
    const DenseConv<bf16> s0 = c.st[0];
    c.st[0] = c.st[1];
    c.st[1] = s0;
  }
  c.plant = plant;
  const size_t bytes = rrdb_smem(C, g);
  int sms = 0, fit = 0;
  cudaError_t e = conv_engine::sm_count(&sms);
  if (e == cudaSuccess)
    e = conv_engine::allow_smem<rrdb_tc_kernel>(
        bytes, conv_engine::tc::NTHREADS, &fit);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&c};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rrdb_tc_kernel),
                                  dim3(sms * fit),
                                  dim3(conv_engine::tc::NTHREADS), args,
                                  bytes, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
