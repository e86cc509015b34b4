// Kernel 10, flash window attention, hand-written for sm_90a.
//
// Replaces superresolution_tpu/ops/pallas_attn.py: flash_window_attention
// (_flash_fwd_impl, _kernel, _kernel_masked, _attn_window). Per window b
// and head h, with hd = C / nh = 16 and scale = hd^-1/2:
//
//   logits = q_h k_h^T * scale + bias[h]  (+ -1e9 where the Swin region
//            ids of query i and key j differ, region_ids[b % nw_img])
//   out_h  = T(softmax(logits)) v_h
//
// q [nb, 64, C]; k, v [nb, M, C] with M = 64 (self-attention) or 121 / 144
// (the OCAB's 11x11 / 12x12 key windows); bias [nh, 64, M] f32; ids
// [nw_img, 64] int32 or null. T is bf16 on the deploy path, f32 for the
// exact check. Rounding follows the reference: products and softmax in
// f32, the probabilities rounded to T before the product with v, that
// product summed in f32 and the output stored in T. The -1e9 mask
// underflows to exactly 0 in expf. The Pallas kernel's TPU layout
// (masked-K head packing, the stacked bias, window blocks) is not carried
// over: nothing in it is needed on this card.
//
// Layout: one thread block of 256 threads per window. The block copies
// the window's q, k and v rows into shared memory (16-byte loads where
// the pointers and strides allow, else element loads), so q, k and v may
// be strided views: the row stride is an argument, and the split of the
// packed qkv projection ([nb, n, 3C], row stride 3C) is read in place,
// with no copy. Query row i = tid / 4 is held by four lanes; lane g takes
// the keys g, g + 4, ... Each head's output overwrites that head's
// columns of the q tile (only the row's own four lanes read them, and
// they have by then), and the finished tile is written back with 16-byte
// stores. No atomics: the result is deterministic.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 2 * 2 * 64 * M * 16
// FLOP per window and head against (64 + 2M + 64) * C * 2 bytes, 12 to
// 17 FLOP/B: bound by bytes, far below the ~295 FLOP/B ridge. This first
// form does the products on the CUDA cores in f32 FMA (67 TFLOP/s), which
// at these shapes costs more than the bytes (2.2 ms for the OCAB call of
// the 8-tile batch, against its 0.99 ms byte bound); the tensor cores
// (mma / wgmma on bf16 tiles) are the next step. It does keep one pass:
// every q, k, v element is read once and every output written once; the
// logits never leave registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e9f;
constexpr int HD = 16;     // head dim
constexpr int N = 64;      // queries per window (8x8)
constexpr int NT = 256;    // threads per block, 4 per query row
constexpr int MAX_C = 128; // channels the shared-memory budget allows

__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, bf16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 consecutive head dims from shared memory (16-byte aligned) as f32.
__device__ __forceinline__ void read16(const bf16* p, float (&d)[HD]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const uint4 w = reinterpret_cast<const uint4*>(p)[u];
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = words[k];
      const float2 t = __bfloat1622float2(h);
      d[8 * u + 2 * k] = t.x;
      d[8 * u + 2 * k + 1] = t.y;
    }
  }
}
__device__ __forceinline__ void read16(const float* p, float (&d)[HD]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 t = reinterpret_cast<const float4*>(p)[u];
    d[4 * u] = t.x;
    d[4 * u + 1] = t.y;
    d[4 * u + 2] = t.z;
    d[4 * u + 3] = t.w;
  }
}

// rows x C elements of a global tile with row stride rs -> shared memory
// with row stride ld. vec: every row start is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long rs, int rows, int C,
                                          bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int cv = C / V;
    for (int e = threadIdx.x; e < rows * cv; e += NT) {
      const int r = e / cv, c = (e % cv) * V;
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(src + r * rs + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * C; e += NT) {
      const int r = e / C, c = e % C;
      dst[r * ld + c] = src[r * rs + c];
    }
  }
}

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  long long q_bs, q_rs;  // window and row strides, in elements
  long long k_bs, k_rs;
  long long v_bs, v_rs;
  const float* bias;     // [nh, N, M]
  const int* ids;        // [nw_img, N] or null
  int nw_img;
  void* out;             // [nb, N, C], contiguous
  int C, nh;
  float scale;
  int vec;
};

// shared-memory row padding: 16 bytes, so 16-byte accesses stay aligned
template <typename T>
__host__ __device__ constexpr int row_pad() { return 16 / (int)sizeof(T); }

template <typename T, int M>
size_t smem_bytes(int C) {
  return (size_t)(N + 2 * M) * (C + row_pad<T>()) * sizeof(T) +
         N * sizeof(int);
}

template <typename T, int M>
__global__ void __launch_bounds__(NT) window_attn_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int JJ = (M + 3) / 4;
  const int ld = a.C + row_pad<T>();
  T* qs = reinterpret_cast<T*>(smem);  // q, then the output
  T* ks = qs + N * ld;
  T* vs = ks + M * ld;
  int* ids = reinterpret_cast<int*>(vs + M * ld);
  const long long b = blockIdx.x;
  const bool masked = a.ids != nullptr;

  load_rows(qs, ld, static_cast<const T*>(a.q) + b * a.q_bs, a.q_rs, N, a.C,
            a.vec);
  load_rows(ks, ld, static_cast<const T*>(a.k) + b * a.k_bs, a.k_rs, M, a.C,
            a.vec);
  load_rows(vs, ld, static_cast<const T*>(a.v) + b * a.v_bs, a.v_rs, M, a.C,
            a.vec);
  if (masked && threadIdx.x < N)
    ids[threadIdx.x] = a.ids[(size_t)(b % a.nw_img) * N + threadIdx.x];
  __syncthreads();

  const int i = threadIdx.x >> 2, g = threadIdx.x & 3;
  for (int h = 0; h < a.nh; ++h) {
    const int c0 = h * HD;
    const float* brow = a.bias + ((size_t)h * N + i) * M;
    float q[HD];
    read16(qs + i * ld + c0, q);
    float s[JJ];
    float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      const int j = g + 4 * jj;
      if (j < M) {
        float kv[HD];
        read16(ks + j * ld + c0, kv);
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc = fmaf(q[d], kv[d], acc);
        float t = acc * a.scale + brow[j];
        if (masked && ids[i] != ids[j]) t += kNeg;
        s[jj] = t;
        mx = fmaxf(mx, t);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      if (g + 4 * jj < M) {
        s[jj] = expf(s[jj] - mx);
        sum += s[jj];
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    float o[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = 0.f;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      const int j = g + 4 * jj;
      if (j < M) {
        const float p = rnd(s[jj] / sum, T());
        float vv[HD];
        read16(vs + j * ld + c0, vv);
#pragma unroll
        for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vv[d], o[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      o[d] += __shfl_xor_sync(0xffffffffu, o[d], 1);
      o[d] += __shfl_xor_sync(0xffffffffu, o[d], 2);
    }
    // lane g stores head dims 4g..4g+3 over the q it no longer needs
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if ((d >> 2) == g) put(qs + i * ld + c0 + d, o[d]);
  }
  __syncthreads();
  constexpr int V = 16 / sizeof(T);
  const int cv = a.C / V;
  T* out = static_cast<T*>(a.out) + b * N * a.C;
  for (int e = threadIdx.x; e < N * cv; e += NT) {
    const int r = e / cv, c = (e % cv) * V;
    *reinterpret_cast<uint4*>(out + r * a.C + c) =
        *reinterpret_cast<const uint4*>(qs + r * ld + c);
  }
}

template <typename T, int M>
int launch(const AttnArgs& a, int nb, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, M>(a.C);
  cudaError_t e = cudaFuncSetAttribute(
      window_attn_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  window_attn_kernel<T, M><<<nb, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const AttnArgs& a, int nb, int m, cudaStream_t stream) {
  switch (m) {
    case 64: return launch<T, 64>(a, nb, stream);
    case 121: return launch<T, 121>(a, nb, stream);
    case 144: return launch<T, 144>(a, nb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One launch of kernel 10; returns the cudaError_t of the launch (0 on
// success), cudaErrorInvalidValue for a geometry it does not take.
// f32 != 0: q, k, v, out are f32, else bf16.
int attn_window(const void* q, long long q_bs, long long q_rs,
                const void* k, long long k_bs, long long k_rs,
                const void* v, long long v_bs, long long v_rs,
                const void* bias, const void* ids, int nw_img, void* out,
                int nb, int n, int m, int C, int nh, float scale, int f32,
                int vec, void* stream) {
  if (n != N || nh < 1 || C != nh * HD || C > MAX_C || nb < 1 ||
      (ids && (m != n || nw_img <= 0 || nb % nw_img)))
    return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.bias = static_cast<const float*>(bias);
  a.ids = static_cast<const int*>(ids);
  a.nw_img = nw_img;
  a.out = out;
  a.C = C;
  a.nh = nh;
  a.scale = scale;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<float>(a, nb, m, s) : dispatch<bf16>(a, nb, m, s);
}

}  // extern "C"
