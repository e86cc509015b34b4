// Streaming kernels (sm_90a): persistent blocks, sized from the SM count,
// that walk their share of a map or buffer with the next reads in flight
// while they work on this one, so every input byte is read from HBM about
// once. B3 streams the rows of an NHWC map through a ring of shared-memory
// buffers; kernel 19 copies a buffer.
//
//   B3 conv_last  (replaces superresolution_tpu/ops/pallas_phase_tail.py:
//      _last_kernel, called by _run_last): out = conv3x3_SAME(y, w) + b
//      for y [B, H, W, cin] bf16 (cin % 8 == 0, cin <= 64), w [3, 3, cin,
//      cout] bf16 (cout <= 4), b [cout] f32, out [B, H, W, cout] bf16: f32
//      sums, one rounding. The TPU kernel evaluates the conv in phase
//      space at LR as one dot; the port computes the same function on the
//      4x map that B2 writes (ops/phase_tail.conv_last_phase).
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): 9 * 64 * 3 = 1,728 MACs
// per pixel against 134 bytes (64 channels in, 3 out), 13 MACs a byte, far
// below the ridge (~148): bound by bytes. At the ESRGAN tail's [8, 1504,
// 1024, 64] that is 1.65 GB, 0.49 ms. On the CUDA cores the 1,728 FFMA per
// pixel alone would take ~0.85 ms at 67 TFLOP/s, so the products go to the
// tensor cores.
//
// Design: tap-major. Each input row of a strip (RING = 128 pixels: 126
// output columns and a 1-pixel ring) goes through ONE GEMM, [128 pixels,
// cin] @ [cin, 9 * cout] (mma.sync m16n8k16, bf16 in, f32 sums; the
// weights live in registers as B fragments for the block's life), which
// gives every tap's partial of every pixel. The row's f32 partials sit in
// shared memory (transposed, [column][pixel], with a row stride that
// makes both the fragments' stores and the reads along x free of bank
// conflicts). Output row y is the sum of nine shifted partials of input
// rows y - 1, y, y + 1, plus the bias, rounded once: the thread of output
// column x adds input row i's shifted partials of ky 0, 1 and 2 into
// running sums it keeps in registers for output rows i, i - 1 and i - 2
// of its unit, and stores row i - 2, now whole. So each input pixel goes
// through HBM once, through ldmatrix once, and into 27 partials instead
// of 9 * 64 * 3 products; one row of partials sits in shared memory; and
// a step's sums are 3 * cout short independent chains.
//
// Streaming: a work unit is BAND output rows of one strip of one image
// (BAND + 2 input rows); persistent blocks (two an SM) take units blockIdx,
// blockIdx + grid, ... in (image, band, strip) order, so blocks running
// together read neighbouring strips of the same rows (their ring columns
// and a band's two ring rows come from L2). Each block streams its units'
// input rows through NBUF row buffers with 16-byte cp.async (zero-filled
// outside the image: SAME padding), NBUF - 1 rows in flight, across unit
// boundaries. The output row, 126 * cout bf16 values, is one contiguous run
// in HBM, written by consecutive threads.
//
//   19 passthrough  (replaces bench.py: dma_probe's make_pt, a Pallas copy
//      with one grid step per band of rb rows): dst = src, a whole buffer
//      of 16-byte words. The band grid is the TPU's layout, not the
//      contract: the copy walks chunks of the buffer, independent of rb.
//
// Kernel 19 is bound by bytes: it reads and writes each byte once, 0.188
// ms for the probe's 314 MB at 3.35 TB/s. Block b copies the b-th chunk
// of COPY_CHUNK words (16 KB; the grid is utils/dma_probe.copy_grid):
// one 16-byte word for each of its 1024 threads. A grid of thousands of
// short blocks, which the hardware keeps the card full with, beat every
// persistent grid of 1 to 4 blocks an SM walking round-robin or
// contiguous chunks, blocks of 8 to 128 KB, 2 or 4 words a thread in
// flight, the non-coherent load and evict-first store forms, and a TMA
// ring that moves the chunks through shared memory by bulk copies
// (scripts/attn_copy_variants.py; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_engine.cuh"

namespace {

namespace ce = conv_engine;
using ce::bf16;

// Faults the checks in chip_smoke.py plant (0 in every other launch).
constexpr int PLANT_ROW_CLAMP = 1;        // the halo row outside the image
                                          // clamped to the border row
constexpr int PLANT_WRONG_NEIGHBOUR = 2;  // tap (ky 1, kx 0) takes the
                                          // partial of pixel x, not x - 1
constexpr int PLANT_BIAS_DROPPED = 4;     // the bias not added

constexpr int TW = 126;            // output columns a strip
constexpr int RING = TW + 2;       // staged pixels a row: 8 M fragments
constexpr int WARPS = RING / 16;   // one M fragment each
constexpr int THREADS = 32 * WARPS;
constexpr int BAND = 64;           // output rows a work unit
constexpr int NBUF = 3;            // input row buffers: NBUF - 1 in flight
constexpr int MAX_CIN = 64;
constexpr int KSTEPS = MAX_CIN / 16;
// partial row stride in floats: 132 % 16 == 4, so a fragment's stores
// (8 pixels x 4 column pairs) and 32 adjacent pixels' reads hit 32 banks
constexpr int PSTRIDE = RING + 4;

static_assert(RING % 16 == 0, "a strip's ring is whole M fragments");

struct LastArgs {
  const bf16* y;      // [B, H, W, cin]
  const bf16* w;      // [3, 3, cin, cout]
  const float* bias;  // [cout]
  bf16* out;          // [B, H, W, cout]
  int B, H, W, cin, strips, bands, units, plant;
};

constexpr size_t last_smem(int cin, int cout) {
  return (size_t)NBUF * RING * (((cin + 15) & ~15) + 8) * 2 +
         (size_t)9 * cout * PSTRIDE * 4;
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int COUT>
__device__ __forceinline__ bf16 weight(const LastArgs& a, int k, int n) {
  if (k >= a.cin || n >= 9 * COUT) return __float2bfloat16(0.f);
  const int tap = n / COUT;
  return a.w[((size_t)tap * a.cin + k) * COUT + (n - tap * COUT)];
}

// A work unit's place: image b, first output row y0, first column x0.
struct Unit {
  int b, y0, x0, rows;
};

__device__ __forceinline__ Unit unit_at(const LastArgs& a, int u) {
  const int strip = u % a.strips, t = u / a.strips;
  const int band = t % a.bands;
  const int y0 = band * BAND;
  return {t / a.bands, y0, strip * TW, min(BAND, a.H - y0)};
}

template <int COUT>
__global__ void __launch_bounds__(THREADS, 2)
    conv_last_kernel(const LastArgs a) {
  constexpr int NCOL = 9 * COUT;        // GEMM columns: tap * COUT + o
  constexpr int NF = (NCOL + 7) / 8;    // 8-column fragments
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = (a.cin + 15) & ~15;    // staged channels, zero past cin
  const int pstr = cp + 8;              // pixel stride: ldmatrix rows on
                                        // distinct banks
  const int cv = cp / 8, ksteps = cp / 16;
  bf16* rows_s = reinterpret_cast<bf16*>(smem);
  float* part_s =
      reinterpret_cast<float*>(smem + (size_t)NBUF * RING * pstr * 2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // B fragments of the whole [cin, 9 * COUT] weight matrix: k rows
  // 2 (lane & 3) + {0, 1} (+ 8), column lane >> 2 of each fragment
  uint32_t bw[KSTEPS][NF][2];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = j * 8 + (lane >> 2);
        const int k = ks * 16 + h * 8 + 2 * (lane & 3);
        bw[ks][j][h] = pack2(weight<COUT>(a, k, n), weight<COUT>(a, k + 1, n));
      }
  float bias[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o)
    bias[o] = (a.plant & PLANT_BIAS_DROPPED) ? 0.f : a.bias[o];

  // A cursor over the block's input rows: unit u, row i of its rows + 2
  struct Cursor {
    int u, i;
  };
  auto next = [&](Cursor& c) {
    if (++c.i == unit_at(a, c.u).rows + 2) {
      c.i = 0;
      c.u += gridDim.x;
    }
  };
  // cp.async of the cursor's input row (y0 - 1 + i) into buffer buf:
  // RING pixels from x0 - 1, cv 16-byte vectors each, zeros outside
  auto stage = [&](const Cursor& c, int buf) {
    const Unit t = unit_at(a, c.u);
    int yy = t.y0 - 1 + c.i;
    if (a.plant & PLANT_ROW_CLAMP) yy = min(max(yy, 0), a.H - 1);
    const bool row_ok = yy >= 0 && yy < a.H;
    const bf16* src_row = a.y + ((size_t)t.b * a.H + yy) * a.W * a.cin;
    bf16* dst = rows_s + (size_t)buf * RING * pstr;
    for (int e = tid; e < RING * cv; e += THREADS) {
      const int p = e / cv, v = e - p * cv;
      const int gx = t.x0 - 1 + p;
      const bool ok = row_ok && gx >= 0 && gx < a.W && v * 8 < a.cin;
      ce::cp_async16_zfill(ce::smem_u32(dst + p * pstr + v * 8),
                           ok ? src_row + (size_t)gx * a.cin + v * 8 : a.y,
                           ok ? 16 : 0);
    }
  };

  Cursor prod{(int)blockIdx.x, 0}, cons = prod;
  for (int s = 0; s < NBUF - 1; ++s) {
    if (prod.u < a.units) {
      stage(prod, s);
      next(prod);
    }
    ce::cp_async_commit();
  }
  // ldmatrix address of this lane: pixel 16 warp + (lane & 15), channels
  // (lane >> 4) * 8 of k-step 0
  const uint32_t a_lane =
      (uint32_t)(((16 * warp + (lane & 15)) * pstr + (lane >> 4) * 8) * 2);

  // the running sums of this thread's output column (tid < TW): output
  // rows i - 1 (ky 0 added) and i - 2 (ky 0 and 1 added) of the unit
  float run1[COUT], run2[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) run1[o] = run2[o] = 0.f;

  for (int s = 0; cons.u < a.units; ++s) {
    ce::cp_async_wait<NBUF - 2>();  // the row of step s has landed
    __syncthreads();                // ... for every thread; its buffer of
                                    // step s - 1 and the partials are free
    if (prod.u < a.units) {
      stage(prod, (s + NBUF - 1) % NBUF);
      next(prod);
    }
    ce::cp_async_commit();

    // every tap's partial of the row's RING pixels, this warp's 16
    float acc[NF][4];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    const uint32_t a_addr =
        ce::smem_u32(rows_s + (size_t)(s % NBUF) * RING * pstr) + a_lane;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      if (ks < ksteps) {
        uint32_t af[4];
        ce::ldmatrix_x4(af, a_addr + ks * 32);
#pragma unroll
        for (int j = 0; j < NF; ++j)
          ce::mma_bf16(acc[j], af, bw[ks][j][0], bw[ks][j][1]);
      }
    }
    // accumulator (j, q): pixel 16 warp + (lane >> 2) + 8 (q >> 1),
    // column 8 j + 2 (lane & 3) + (q & 1)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = j * 8 + 2 * (lane & 3) + (q & 1);
        if (n < NCOL)
          part_s[n * PSTRIDE + 16 * warp + (lane >> 2) + 8 * (q >> 1)] =
              acc[j][q];
      }
    __syncthreads();

    // input row i (image row y0 + i - 1) adds its ky 0 taps to output row
    // y0 + i, ky 1 to y0 + i - 1 and ky 2 to y0 + i - 2, which is then
    // whole: f32 sums in the order bias, ky 0, 1, 2 (kx 0, 1, 2 in each)
    const Unit t = unit_at(a, cons.u);
    const int ncols = min(TW, a.W - t.x0);
    if (tid < ncols) {
      const bool wrong = a.plant & PLANT_WRONG_NEIGHBOUR;
      const bool whole = cons.i >= 2;  // output row y0 + i - 2 exists
      bf16* dst = whole ? a.out + (((size_t)t.b * a.H + t.y0 + cons.i - 2) *
                                       a.W + t.x0 + tid) * COUT
                        : nullptr;
#pragma unroll
      for (int o = 0; o < COUT; ++o) {
        float r[3] = {bias[o], run1[o], run2[o]};
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int px = (wrong && ky == 1 && kx == 0) ? tid + 1 : tid + kx;
            r[ky] += part_s[((ky * 3 + kx) * COUT + o) * PSTRIDE + px];
          }
        if (whole) dst[o] = __float2bfloat16(r[2]);
        run2[o] = r[1];
        run1[o] = r[0];
      }
    }
    next(cons);
  }
  ce::cp_async_wait<0>();
}

template <int COUT>
int launch_last(const LastArgs& a, cudaStream_t s) {
  const size_t bytes = last_smem(a.cin, COUT);
  int sms = 0, per_sm = 0;
  cudaError_t e = ce::allow_smem<conv_last_kernel<COUT>>(bytes, THREADS,
                                                         &per_sm);
  if (e == cudaSuccess) e = ce::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = a.units < sms * per_sm ? a.units : sms * per_sm;
  conv_last_kernel<COUT><<<grid, THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- kernel 19 --------------------------------------------------------

constexpr int COPY_PLANT_LAST_BAND = 1;  // the last band's words not stored
constexpr int COPY_THREADS = 1024;
constexpr int COPY_WORDS = 1;            // 16-byte words a thread
constexpr long long COPY_CHUNK = COPY_THREADS * COPY_WORDS;  // a block's

// Block b copies words [b COPY_CHUNK, (b + 1) COPY_CHUNK) of the `words`
// of src into dst, a thread's loads all in flight before its stores; a
// word at or past `keep` is not stored (the planted fault).
__global__ void __launch_bounds__(COPY_THREADS) copy_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst, long long words,
    long long keep) {
  const long long w0 = blockIdx.x * COPY_CHUNK + threadIdx.x;
  uint4 v[COPY_WORDS];
#pragma unroll
  for (int u = 0; u < COPY_WORDS; ++u)
    if (w0 + u * COPY_THREADS < words) v[u] = src[w0 + u * COPY_THREADS];
#pragma unroll
  for (int u = 0; u < COPY_WORDS; ++u)
    if (w0 + u * COPY_THREADS < keep) dst[w0 + u * COPY_THREADS] = v[u];
}

}  // namespace

extern "C" {

// B3: y [B, H, W, cin] -> out [B, H, W, cout], all bf16 but bias (f32);
// cin % 8 == 0, 8 <= cin <= 64, 1 <= cout <= 4. plant: 0 but in the
// checks that plant faults. Returns the cudaError_t of the launch.
int stream_conv_last(const void* y, int B, int H, int W, int cin,
                     const void* w, const float* bias, int cout, void* out,
                     int plant, void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin < 8 || cin > MAX_CIN || cin % 8 ||
      cout < 1 || cout > 4)
    return (int)cudaErrorInvalidValue;
  LastArgs a{static_cast<const bf16*>(y), static_cast<const bf16*>(w), bias,
             static_cast<bf16*>(out), B, H, W, cin, (W + TW - 1) / TW,
             (H + BAND - 1) / BAND, 0, plant};
  const long long units = (long long)B * a.strips * a.bands;
  if (units > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 1: return launch_last<1>(a, s);
    case 2: return launch_last<2>(a, s);
    case 3: return launch_last<3>(a, s);
    default: return launch_last<4>(a, s);
  }
}

// Kernel 19: dst = src, `bytes` (a multiple of 16; both 16-byte aligned),
// on a grid of one block a chunk of COPY_CHUNK words: `blocks` must be
// that grid. plant COPY_PLANT_LAST_BAND leaves the last band_bytes
// unwritten. Returns the cudaError_t of the launch.
int stream_copy(const void* src, void* dst, long long bytes, int blocks,
                long long band_bytes, int plant, void* stream) {
  if (bytes < 16 || bytes % 16 || band_bytes < 16 || band_bytes % 16 ||
      band_bytes > bytes)
    return (int)cudaErrorInvalidValue;
  const long long words = bytes / 16;
  if (blocks != (words + COPY_CHUNK - 1) / COPY_CHUNK)
    return (int)cudaErrorInvalidValue;
  const long long keep =
      plant & COPY_PLANT_LAST_BAND ? words - band_bytes / 16 : words;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  copy_kernel<<<blocks, COPY_THREADS, 0, s>>>(static_cast<const uint4*>(src),
                                              static_cast<uint4*>(dst), words,
                                              keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
