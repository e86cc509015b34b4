// Kernel 10: window attention, hand-written for sm_90a.
//
// 10 flash_window_attention  (replaces superresolution_tpu/ops/
//    pallas_attn.py: flash_window_attention, _flash_fwd_impl, _kernel,
//    _kernel_masked, _attn_window). Per window b and head h, with head
//    dim hd = C / nh and scale = hd^-1/2:
//
//      logits = q_h k_h^T * scale + bias[h]  (+ -1e9 where the Swin region
//               ids of query i and key j differ)
//      out_h  = softmax(logits) v_h
//
//    Two forms of its keys:
//    - windows (attn_window_tc): q [nb, N, C]; k, v [nb, M, C] strided
//      views (window and row strides are arguments, so the split of a
//      packed qkv projection is read in place); ids [nw_img, N] int32 or
//      null, window b reads row b % nw_img;
//    - the map (attn_map_tc, the HAB's self-attention): q, k and v read
//      from the qkv map [B, H, W, 3C] with the Swin shift as index
//      arithmetic and the region ids from the rolled-frame position, the
//      output written to [B, H, W, C] at the pixels the tokens came from:
//      no roll, window partition or merge around it.
//    bias [nh, N, M] f32, in the accumulators' fragment order
//    (ops/flash_oca.bias_fragments) for these two.
//
// bf16 (attn_tc_kernels.cu, attn_tc_widths16.cu, attn_tc_widths20.cu):
// FlashAttention-2 on the tensor cores,
// flash_tc.cuh's body (kernel 9's, generalised over its key addressing): mma.sync m16n8k16 with f32
// sums, the k and v tiles through a cp.async ring, q staged once, P
// rounded to bf16 as the A fragment, V's B fragments by ldmatrix.trans,
// the bias and the Swin mask in the accumulators. Widths: any C up to
// 128 at head dim 16 and up to 120 at head dim 20, as in f32; (N, M)
// (64, 64), (64, 100), (64, 121), (64, 144), (256, 256), (256, 576) on
// windows, (64, 64) and (256, 256) on the map: 8x8 and 16x16 windows
// against themselves and against the OCAB's 10x10, 11x11, 12x12 and
// 24x24 key windows. The model's widths, (C, heads) (96, 6), (128, 8)
// and (120, 6), have every key count compiled in; the others read a
// window form's at run time. Anything else is refused with
// cudaErrorInvalidValue.
//
// f32 (the exact check, attn_window): attn_kernel in this file, on the
// CUDA cores, any C up to 128 (head dim 16) or 120 (head dim 20), the raw
// bias, the same (N, M). (Its bf16 instances were kernel 10's first form
// until the tensor-core body replaced them; PERF.md row 10 keeps their
// times.) attn_kernel's layout: one thread block of 256 threads per
// (window, head). The block stages the head's M keys and values in shared
// memory, reading 4 elements (16 bytes) at a time where every row start
// is 4-element aligned and single elements otherwise. Query row i = tid /
// LPQ is held by LPQ = 256 / N lanes (4 at N 64, 1 at N 256); lane g
// takes the keys g, g + LPQ, ... and runs an online softmax over them in
// steps of KC keys (running max, rescaled sum and output), so no lane
// holds more than KC logits whatever M is; the lanes of a row merge their
// (max, sum, output) at the end. Logits, softmax and the product with v
// in f32. The -1e9 mask underflows to exactly 0 in expf. No atomics:
// deterministic.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 2 * 2 * N * M * hd
// FLOP per window and head against (2N + 2M) * C * 2 bytes in bf16, 12 to
// 48 FLOP/B: bound by bytes, far below the ~295 FLOP/B ridge; the
// exponentials (one a logit) set a second floor on the special-function
// units. Every q, k, v element is read once per block from device memory
// and every output written once; the logits never leave registers.
// attn_kernel does the products on the CUDA cores in f32 FMA (67
// TFLOP/s) and reads the bias through L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int NT = 256;  // threads per block
constexpr int KC = 8;    // keys a lane takes per online-softmax step

// 4 consecutive elements: one 16-byte load when vec, else four element
// loads.
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

struct AttnArgs {
  const float* q;
  const float* k;         // windows [nb, M, C]
  const float* v;
  long long q_bs, q_rs;   // window and row strides, in elements
  long long k_bs, k_rs;
  long long v_bs, v_rs;
  const float* bias;      // [nh, N, M]
  const int* ids;         // [nw_img, N] or null
  int nw_img;
  float* out;             // [nb, N, C], contiguous
  int C, nh;
  float scale;
  int vec;                // every row start of q, k, v is 4-element aligned
};

template <int HD, int M>
constexpr size_t smem_bytes(int n) {
  return (size_t)2 * M * (HD + 4) * sizeof(float) + n * sizeof(int);
}

template <int HD, int N, int M>
__global__ void __launch_bounds__(NT) attn_kernel(const AttnArgs a) {
  constexpr int LPQ = NT / N;   // lanes per query row
  constexpr int LD = HD + 4;    // f32 row stride: 16-byte rows, no bank
                                // conflicts between the LPQ lanes' rows
  constexpr int DPL = HD / LPQ; // output dims each lane stores
  static_assert(NT % N == 0 && HD % 4 == 0 && HD % LPQ == 0, "geometry");
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + M * LD;
  int* ids = reinterpret_cast<int*>(vs + M * LD);
  const long long b = blockIdx.x / a.nh;
  const int h = blockIdx.x % a.nh;
  const int c0 = h * HD;
  const bool vec = a.vec != 0;
  const bool masked = a.ids != nullptr;

  const float* kp = a.k + c0;
  const float* vp = a.v + c0;
  for (int e = threadIdx.x; e < M * (HD / 4); e += NT) {
    const int j = e / (HD / 4), d = (e % (HD / 4)) * 4;
    *reinterpret_cast<float4*>(ks + j * LD + d) =
        load4(kp + b * a.k_bs + j * a.k_rs + d, vec);
    *reinterpret_cast<float4*>(vs + j * LD + d) =
        load4(vp + b * a.v_bs + j * a.v_rs + d, vec);
  }
  if (masked)
    for (int t = threadIdx.x; t < N; t += NT)
      ids[t] = a.ids[(size_t)(b % a.nw_img) * N + t];
  __syncthreads();

  const int i = threadIdx.x / LPQ, g = threadIdx.x % LPQ;
  const float* qrow = a.q + b * a.q_bs + i * a.q_rs + c0;
  float q[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 t = load4(qrow + d, vec);
    q[d] = t.x;
    q[d + 1] = t.y;
    q[d + 2] = t.z;
    q[d + 3] = t.w;
  }
  const float* brow = a.bias + ((size_t)h * N + i) * M;
  const int id_i = masked ? ids[i] : 0;
  float mx = __int_as_float(0xff800000);  // -inf
  float l = 0.f;
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;

  for (int j0 = g; j0 < M; j0 += LPQ * KC) {
    float s[KC];
    float cm = __int_as_float(0xff800000);
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      const int j = j0 + LPQ * u;
      s[u] = __int_as_float(0xff800000);  // -inf: no key
      if (j < M) {
        const float* kr = ks + j * LD;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          acc = fmaf(q[d], k4.x, acc);
          acc = fmaf(q[d + 1], k4.y, acc);
          acc = fmaf(q[d + 2], k4.z, acc);
          acc = fmaf(q[d + 3], k4.w, acc);
        }
        float t = acc * a.scale + brow[j];
        if (masked && id_i != ids[j]) t += kNeg;
        s[u] = t;
      }
    }
#pragma unroll
    for (int u = 0; u < KC; ++u) cm = fmaxf(cm, s[u]);
    const float mn = fmaxf(mx, cm);   // finite: key j0 < M exists
    const float corr = expf(mx - mn); // 0 on the first step
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] *= corr;
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      const int j = j0 + LPQ * u;
      if (j < M) {
        const float p = expf(s[u] - mn);
        l += p;
        const float* vr = vs + j * LD;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
          o[d] = fmaf(p, v4.x, o[d]);
          o[d + 1] = fmaf(p, v4.y, o[d + 1]);
          o[d + 2] = fmaf(p, v4.z, o[d + 2]);
          o[d + 3] = fmaf(p, v4.w, o[d + 3]);
        }
      }
    }
    mx = mn;
  }
  // merge the LPQ lanes of the row: every lane ends with the row's total
#pragma unroll
  for (int off = 1; off < LPQ; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, mx, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(mx, mo);
    const float fa = expf(mx - mn), fb = expf(mo - mn);
    l = l * fa + lo * fb;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const float od = __shfl_xor_sync(0xffffffffu, o[d], off);
      o[d] = o[d] * fa + od * fb;
    }
    mx = mn;
  }
  float* orow = a.out + ((size_t)b * N + i) * a.C + c0;
#pragma unroll
  for (int d = 0; d < HD; ++d)
    if (d / DPL == g) orow[d] = o[d] / l;
}

template <int HD, int N, int M>
int launch(const AttnArgs& a, long long nb, cudaStream_t stream) {
  const size_t bytes = smem_bytes<HD, M>(N);
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<HD, N, M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  attn_kernel<HD, N, M>
      <<<(unsigned)(nb * a.nh), NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_window(const AttnArgs& a, long long nb, int n, int m,
                    cudaStream_t s) {
  if (n == 64) {
    switch (m) {
      case 64: return launch<HD, 64, 64>(a, nb, s);
      case 100: return launch<HD, 64, 100>(a, nb, s);
      case 121: return launch<HD, 64, 121>(a, nb, s);
      case 144: return launch<HD, 64, 144>(a, nb, s);
    }
  } else if (n == 256) {
    switch (m) {
      case 256: return launch<HD, 256, 256>(a, nb, s);
      case 576: return launch<HD, 256, 576>(a, nb, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch of attn_kernel (the CUDA-core form, f32: q, k, v, out and the
// raw bias [nh, n, m]); returns the cudaError_t of the launch (0 on
// success), cudaErrorInvalidValue for a geometry it does not take.
int attn_window(const void* q, long long q_bs, long long q_rs,
                const void* k, long long k_bs, long long k_rs,
                const void* v, long long v_bs, long long v_rs,
                const void* bias, const void* ids, int nw_img, void* out,
                int nb, int n, int m, int C, int nh, float scale, int vec,
                void* stream) {
  const int hd = nh > 0 ? C / nh : 0;
  if (nh < 1 || C != nh * hd || nb < 1 || !(hd == 16 || hd == 20) ||
      C > (hd == 16 ? 128 : 120) ||
      (ids && (m != n || nw_img <= 0 || nb % nw_img)))
    return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.bias = static_cast<const float*>(bias);
  a.ids = static_cast<const int*>(ids);
  a.nw_img = nw_img;
  a.out = static_cast<float*>(out);
  a.C = C;
  a.nh = nh;
  a.scale = scale;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 16 ? dispatch_window<16>(a, nb, n, m, s)
                  : dispatch_window<20>(a, nb, n, m, s);
}

}  // extern "C"
