// Hand-written CUDA kernels of the RRDB trunk's levers and the direct
// conv that several kernels share (sm_90a).
//
// One direct NHWC 3x3 SAME convolution routine on the CUDA cores (f32
// FFMA sums of bf16 inputs) with fused epilogues, conv_tile. It carries:
//   - B1's shapes that the tensor-core route does not take (C or g not a
//     multiple of 8, C + 4g > 256; ops/dense_trunk.uses_tensor_cores):
//     five launches of conv3x3_kernel. B1's route at the models' widths
//     is dense_kernels.cu, on the conv engine's tensor cores; B2 is
//     tail_kernels.cu's.
//   - the two convs of the hybrid path's CAB (hat_kernels.cu, kernel 7),
//     through its exact-GELU epilogue;
//   - the transposed convs of the dense block's backward (kernel 13) at
//     the shapes its route rule sends off the tensor cores, through its
//     lrelu' gate and scaled-add epilogues (the models' widths run
//     train_tc_kernels.cu's);
//   - kernels 4-6, the trunk's levers, as stages of conv_chain_kernel,
//     at the shapes B1's route rule (ops/dense_trunk.uses_tensor_cores)
//     sends off the tensor cores: bf16 with C or g not a multiple of 8,
//     or C + 4g > 256 (f32 activations the wrappers refuse). The
//     models' widths run dense_kernels.cu: kernel 4 as conv_first on the
//     conv engine's direct body then B1's five tensor-core launches,
//     kernel 5 as B1's five and trunk_conv on the tensor cores, kernel 6
//     as rrdb_tc_kernel, B1's tile body in persistent blocks:
//   4 fused_dense_block_prologue  (replaces ops/pallas_dense_trunk.py:
//      fused_dense_block_prologue): conv_first then dense block 0, six
//      stages of conv_chain_kernel in one cooperative launch.
//   5 fused_dense_block_epilogue  (replaces ops/pallas_dense_trunk.py:
//      fused_dense_block_epilogue): the last dense block with the RRDB
//      residual, then trunk_conv + the global residual, six stages.
//   6 fused_rrdb  (replaces ops/pallas_dense_trunk.py: fused_rrdb,
//      _rrdb_kernel): one whole RRDB, three dense blocks and the x0.2
//      residual, fifteen stages.
//   (See conv_chain_kernel for why one launch of stages separated by
//      grid-wide barriers stands in for the TPU's in-VMEM halo cascade.)
//
// With `seg` (ops/pallas_dense_trunk.py _roll_conv3's batch-packed rows:
// images stacked along H, stride rows apiece, the last stride - valid of
// them zero spacers) a launch reads spacer rows as zero and writes them
// as 0, so each image sees exact SAME padding through a chain of convs.
//
// Bounds on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): a dense block
// does 239,616 MACs per pixel for 256-384 bytes, so kernels 4-6 (B1's
// MACs plus 9*Cin*64 for kernel 4, plus 36,864 for kernel 5; three times
// B1's for kernel 6, 718,848 per pixel) are bound by operations.
//
// What this simple design leaves on the table: the sums run on the CUDA
// cores in f32 (FFMA, 67 TFLOP/s peak), not on the tensor cores, so it
// can reach at most ~7% of the bf16 bound; the conv engine's tensor-core
// body (conv_engine.cuh; B1's, B2's and, at the models' widths, 4's, 5's,
// 6's and 13's route) is the way for 7's convs too. The chains also
// round-trip the 4g workspace channels through device memory, which an
// in-shared-memory cascade would avoid.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 8;     // output rows per block
constexpr int TW = 32;    // output columns per block
constexpr int CK = 8;     // input channels staged per chunk
constexpr int PPT = 4;    // consecutive output pixels per thread (along W)
constexpr int NCG = 4;    // output-channel groups per block
constexpr int NTHREADS = (TH * TW / PPT) * NCG;  // 256

struct ConvArgs {
  // Logical input channel c < cin0 reads source 0, else source 1 at
  // channel c - cin0. Sources are NHWC with `stride` channels per pixel.
  const __nv_bfloat16* in0;
  int in0_stride, cin0;
  const __nv_bfloat16* in1;
  int in1_stride, cin1;
  int B, H, W;                  // geometry of the conv's input
  // Batch-packed rows (B1's direct route and kernel 13 with `seg`): row
  // y of the map is
  // an image row when y % seg_stride < seg_valid, else a spacer, which
  // every load reads as zero padding and every store writes as 0.
  // seg_stride 0: no spacers. seg_plant 1 (a planted fault, checks
  // only): spacer rows are not zeroed at the store.
  int seg_stride, seg_valid, seg_plant;
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

// False for a spacer row of a batch-packed map (see ConvArgs).
__device__ __forceinline__ bool image_row(const ConvArgs& a, int y) {
  return a.seg_stride == 0 || y % a.seg_stride < a.seg_valid;
}

__device__ __forceinline__ float load_in(const ConvArgs& a, int b, int y,
                                         int x, int c) {
  const size_t pix = ((size_t)b * a.H + y) * a.W + x;
  if (c < a.cin0) return __bfloat162float(a.in0[pix * a.in0_stride + c]);
  return __bfloat162float(a.in1[pix * a.in1_stride + (c - a.cin0)]);
}

// One TH x TW output tile times CO_T output channels of a conv: tile
// index t = x-tile + nx * (y-tile + ny * (b * n_co + channel group)). Per
// chunk of CK input channels, the input tile plus a 1-pixel halo (zero
// outside the image) and the chunk's 3x3 weights are staged in shared
// memory as f32 (in_s [CK][TH+2][TW+2], w_s [9][CK][CO_T]); each thread
// accumulates PPT x (CO_T / NCG) outputs in registers. Every thread of
// the block calls it for the same tile.
template <int CO_T>
__device__ __forceinline__ void conv_tile(const ConvArgs& a, int t,
                                          float* in_s, float* w_s) {
  constexpr int CPT = CO_T / NCG;
  constexpr int IH = TH + 2, IW = TW + 2;
  static_assert(CPT % 4 == 0, "CPT must be a multiple of 4");
  const int nx = (a.W + TW - 1) / TW, ny = (a.H + TH - 1) / TH;
  const int n_co = (a.cout + CO_T - 1) / CO_T;
  const int x0 = (t % nx) * TW;
  const int y0 = ((t / nx) % ny) * TH;
  const int bz = t / (nx * ny);
  const int b = bz / n_co;
  const int co0 = (bz % n_co) * CO_T;

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pid = tid / NCG;
  const int ty = pid / (TW / PPT);
  const int tx = (pid % (TW / PPT)) * PPT;
  const int cin = a.cin0 + a.cin1;

  float acc[PPT][CPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[p][k] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    for (int e = tid; e < CK * IH * IW; e += NTHREADS) {
      const int ci = e % CK;
      const int pix = e / CK;
      const int px = pix % IW;
      const int py = pix / IW;
      const int gy = y0 + py - 1;
      const int gx = x0 + px - 1;
      const int c = c0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < cin &&
          image_row(a, gy))
        v = load_in(a, b, gy, gx, c);
      in_s[(ci * IH + py) * IW + px] = v;
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
  const bool spacer = !image_row(a, gy) && !a.seg_plant;
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
      if (spacer) v = 0.f;
      a.out[pix * a.out_stride + a.out_off + o] = __float2bfloat16(v);
    }
  }
}

__host__ __device__ inline int conv_tiles(const ConvArgs& a, int co_t) {
  return ((a.W + TW - 1) / TW) * ((a.H + TH - 1) / TH) * a.B *
         ((a.cout + co_t - 1) / co_t);
}

// One launch, one tile per block, two blocks per SM.
template <int CO_T>
__global__ void __launch_bounds__(NTHREADS, 2)
    conv3x3_kernel(const ConvArgs a) {
  __shared__ float in_s[CK * (TH + 2) * (TW + 2)];
  __shared__ __align__(16) float w_s[9 * CK * CO_T];
  conv_tile<CO_T>(
      a, blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z), in_s,
      w_s);
}

template <int CO_T>
cudaError_t launch_conv3x3(const ConvArgs& a, cudaStream_t s) {
  const int n_co = (a.cout + CO_T - 1) / CO_T;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, a.B * n_co);
  conv3x3_kernel<CO_T><<<grid, NTHREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// ---- kernels 4, 5, 6: a chain of convs in one cooperative launch -------
//
// The TPU kernels keep a halo cascade of up to 16 convs in VMEM; on this
// card a halo-15 tile of 64 + 128 channels (~0.8 MB) does not fit shared
// memory, so each conv of the chain is a stage over the whole tensor:
// the persistent blocks walk its output tiles through conv_tile and a
// grid-wide barrier (cooperative_groups) separates one stage from the
// next, whose halo reads the neighbouring blocks' outputs. The dense
// block's y_1..y_4 and the block outputs between stages live in device
// memory (workspace [B,H,W,4g] and one [B,H,W,C] buffer). One launch per
// call, as the TPU kernel is one program per call: a chained RRDB is 15
// stages and 14 barriers in one kernel, not 15 launches.

constexpr int MAX_STAGES = 16;

struct ChainArgs {
  int n;
  ConvArgs st[MAX_STAGES];
};
static_assert(sizeof(ChainArgs) <= 4096, "kernel parameters are 4 KB");

// Two blocks per SM: unbounded, the two conv_tile instances take 162
// registers a thread and leave one block of 8 warps an SM.
__global__ void __launch_bounds__(NTHREADS, 2)
    conv_chain_kernel(const ChainArgs c) {
  __shared__ float in_s[CK * (TH + 2) * (TW + 2)];
  __shared__ __align__(16) float w_s[9 * CK * 64];
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < c.n; ++s) {
    const ConvArgs& a = c.st[s];
    const bool narrow = a.cout <= 32;
    const int tiles = conv_tiles(a, narrow ? 32 : 64);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      if (narrow)
        conv_tile<32>(a, t, in_s, w_s);
      else
        conv_tile<64>(a, t, in_s, w_s);
    }
    if (s + 1 < c.n) grid.sync();
  }
}

ConvArgs plain_conv(const bf16* in0, int cin0, const bf16* in1, int in1_stride,
                    int cin1, int B, int H, int W, const void* w,
                    const void* bias, bf16* out, int out_stride, int out_off,
                    int cout) {
  ConvArgs a = {};
  a.in0 = in0;
  a.in0_stride = cin0;
  a.cin0 = cin0;
  a.in1 = in1;
  a.in1_stride = in1_stride;
  a.cin1 = cin1;
  a.B = B;
  a.H = H;
  a.W = W;
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.out_stride = out_stride;
  a.out_off = out_off;
  a.cout = cout;
  return a;
}

// The five stages of one dense block (B1's convs) on x [B,H,W,C]:
// conv_j (j < 4) -> lrelu -> workspace channels j*g.., conv_5 ->
// out = x + 0.2 * conv_5 (then res + 0.2 * out when res is given).
void dense_stages(ChainArgs& c, const bf16* x, bf16* ws, bf16* out,
                  const void* const* w, const void* const* bias,
                  const bf16* res, int B, int H, int W, int C, int g) {
  for (int j = 0; j < 4; ++j) {
    ConvArgs a = plain_conv(x, C, ws, 4 * g, j * g, B, H, W, w[j], bias[j],
                            ws, 4 * g, j * g, g);
    a.act = 1;
    c.st[c.n++] = a;
  }
  ConvArgs a = plain_conv(x, C, ws, 4 * g, 4 * g, B, H, W, w[4], bias[4],
                          out, C, 0, C);
  a.xres = x;
  a.xres_stride = C;
  a.res = res;
  a.res_stride = C;
  c.st[c.n++] = a;
}

// Faults a check plants in a chain to show that it sees them (plant is 0
// in use): 1 drops the last stage's residual (res, else the added head,
// else x + 0.2 *); 2 swaps the first two stages, so the second reads what
// the first has not written yet.
enum { PLANT_NO_RESIDUAL = 1, PLANT_SWAP_STAGES = 2 };

cudaError_t launch_chain(ChainArgs& c, int plant, cudaStream_t stream) {
  if (plant & PLANT_NO_RESIDUAL) {
    ConvArgs& z = c.st[c.n - 1];
    if (z.res) z.res = nullptr;
    else if (z.add) z.add = nullptr;
    else z.xres = nullptr;
  }
  if (plant & PLANT_SWAP_STAGES) {
    const ConvArgs t = c.st[0];
    c.st[0] = c.st[1];
    c.st[1] = t;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv_chain_kernel, NTHREADS, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&c};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(conv_chain_kernel),
                                  dim3(sms * per_sm), dim3(NTHREADS), args, 0,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int sr_conv3x3(const void* in0, int in0_stride, int cin0, const void* in1,
               int in1_stride, int cin1, int B, int H, int W,
               const void* w, const void* bias, void* out, int out_stride,
               int out_off, int cout, int act, const void* gate,
               int gate_stride, const void* add, int add_stride,
               float add_scale, const void* xres, int xres_stride,
               const void* res, int res_stride, int seg_stride,
               int seg_valid, int seg_plant, void* stream) {
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
  a.seg_stride = seg_stride;
  a.seg_valid = seg_valid;
  a.seg_plant = seg_plant;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seg_stride != 0 && (seg_valid < 1 || seg_valid > seg_stride))
    return (int)cudaErrorInvalidValue;
  if (cout <= 32) return (int)launch_conv3x3<32>(a, s);
  return (int)launch_conv3x3<64>(a, s);
}

// Kernels 4-6 return the cudaError_t of their one cooperative launch;
// plant is 0 but in the checks that plant faults (launch_chain).

// Kernel 4: conv_first then dense block 0, one launch. x_raw [B,H,W,cin]
// bf16; w, bias: 6 pointers each (conv_first, then the block's five convs,
// HWIO bf16 kernels and f32 biases); ws [B,H,W,4g] scratch; out and head
// [B,H,W,C].
int sr_dense_prologue(const void* x_raw, int cin, const void* const* w,
                      const void* const* bias, void* ws, void* out,
                      void* head, int B, int H, int W, int C, int g,
                      int plant, void* stream) {
  ChainArgs c = {};
  bf16* hd = static_cast<bf16*>(head);
  c.st[c.n++] = plain_conv(static_cast<const bf16*>(x_raw), cin, nullptr, 0,
                           0, B, H, W, w[0], bias[0], hd, C, 0, C);
  dense_stages(c, hd, static_cast<bf16*>(ws), static_cast<bf16*>(out), w + 1,
               bias + 1, nullptr, B, H, W, C, g);
  return (int)launch_chain(c, plant, static_cast<cudaStream_t>(stream));
}

// Kernel 5: the last dense block with the RRDB residual, trunk_conv and
// the global residual, one launch: out = trunk_conv(residual + 0.2 *
// block(x)) + head. w, bias: 6 pointers each (the block's five convs,
// then trunk_conv); ws [B,H,W,4g] and feat [B,H,W,C] scratch.
int sr_dense_epilogue(const void* x, const void* residual, const void* head,
                      const void* const* w, const void* const* bias,
                      void* ws, void* feat, void* out, int B, int H, int W,
                      int C, int g, int plant, void* stream) {
  ChainArgs c = {};
  bf16* ft = static_cast<bf16*>(feat);
  dense_stages(c, static_cast<const bf16*>(x), static_cast<bf16*>(ws), ft, w,
               bias, static_cast<const bf16*>(residual), B, H, W, C, g);
  ConvArgs a = plain_conv(ft, C, nullptr, 0, 0, B, H, W, w[5], bias[5],
                          static_cast<bf16*>(out), C, 0, C);
  a.add = static_cast<const bf16*>(head);
  a.add_stride = C;
  a.add_scale = 1.f;
  c.st[c.n++] = a;
  return (int)launch_chain(c, plant, static_cast<cudaStream_t>(stream));
}

// Kernel 6: one RRDB, one launch: b1 = block(x), b2 = block(b1),
// out = x + 0.2 * block(b2). w, bias: 15 pointers each (three blocks of
// five convs); ws [B,H,W,4g] and tmp [B,H,W,C] scratch; out holds b1
// until the last block overwrites it.
int sr_rrdb(const void* x, const void* const* w, const void* const* bias,
            void* ws, void* tmp, void* out, int B, int H, int W, int C,
            int g, int plant, void* stream) {
  ChainArgs c = {};
  const bf16* xi = static_cast<const bf16*>(x);
  bf16* wk = static_cast<bf16*>(ws);
  bf16* t = static_cast<bf16*>(tmp);
  bf16* o = static_cast<bf16*>(out);
  dense_stages(c, xi, wk, o, w, bias, nullptr, B, H, W, C, g);
  dense_stages(c, o, wk, t, w + 5, bias + 5, nullptr, B, H, W, C, g);
  dense_stages(c, t, wk, o, w + 10, bias + 10, xi, B, H, W, C, g);
  return (int)launch_chain(c, plant, static_cast<cudaStream_t>(stream));
}

const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
