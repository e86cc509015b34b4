// Kernel 9, the OCAB's overlapping cross-attention with its key/value
// gather, as FlashAttention-2 on the tensor cores (sm_90a).
//
//  9 flash_oca_gathered  (replaces superresolution_tpu/ops/
//    pallas_flash_oca.py: flash_oca_gathered, _fwd_impl, _kernel). For
//    each ws x ws query window (wr, wc) of image img and each head h,
//    with head dim hd = C / nh and scale = hd^-1/2:
//
//      out_h = softmax(q_h k_h^T * scale + bias[h]) v_h
//
//    q [B * nh_w * nw_w, ws * ws, C]; the zero-padded key and value maps
//    [B, hp, wp, C] (hp = nh_w * ws + ows - ws); key j of the window is
//    the map pixel (wr * ws + j / ows, wc * ws + j % ows); bias [nh, ws^2,
//    ows^2] f32; all bf16 but the bias. The padded keys are zero vectors
//    whose logits are the bias alone: they take part in the softmax, as
//    in the reference. Logits and softmax in f32; each probability is
//    rounded to bf16 before its product with v (the reference rounds its
//    probabilities to the input type), here before the final division
//    by the row sum, which the online form applies last.
//
// Geometries (C, nh, ws, ows), template instances: (96, 6, 8, 12), (96,
// 6, 8, 10), (96, 6, 16, 24), (120, 6, 16, 24) and the lane-padded (128,
// 8, 8, 12), whose two pad heads read zero q, k and v and write zeros.
//
// Bound on the H100: 2 ows^2 C MACs a query token (14.5 GFLOP at 256
// windows of 16 x 16, ows 24, C 96) against q, out and one read of the
// maps: ~0.017 ms at 989 TFLOP/s, bound by bytes at 3.35 TB/s. The
// exponentials set a second floor: one a logit, nh ws^2 ows^2 a window
// (226.5 M at that shape, ~0.06 ms on the SMs' special-function units),
// and every logit also takes its f32 bias, 4 bytes from L2.
//
// Design: FlashAttention-2 on mma.sync, the body of flash_tc.cuh (shared
// with kernel 10's bf16 launches) with its keys addressed in the padded
// maps (KEYS_OCA): a block 64 queries of a window and all heads, the
// window's key and value patch streamed from the maps through a ring of
// 32-key tiles, the bias re-laid once by the model into the accumulators.

#include "flash_tc.cuh"

namespace {

using flash_tc::FlashArgs;
using flash_tc::KEYS_OCA;

template <int C, int NH, int WS, int OWS, bool PLANTS = false>
int launch_oca(const FlashArgs& a, long long nb, cudaStream_t s) {
  return flash_tc::launch<C, NH, WS, OWS, KEYS_OCA, PLANTS>(a, nb, s);
}

}  // namespace

extern "C" {

// One launch of kernel 9 on bf16 q [B * nh_w * nw_w, ws * ws, C] and maps
// [B, hp, wp, C] (hp = nh_w * ws + ows - ws, wp likewise), the f32 bias
// [nh, ws * ws, ows * ows] divided by scale, in fragment order (ops/
// flash_oca.bias_fragments: for head h, query tile qt of 16 rows, key tile
// kn of 8 keys and lane 4 g + t, the float4 of rows 16 qt + g and + 8 at
// keys 8 kn + 2 t and + 1, zero past ows^2), out like q; (C, nh, ws, ows)
// one of the geometries above; scale = hd^-1/2. plant: 0 but in the
// checks that plant faults, which plant them at (120, 6, 16, 24) only.
// Returns the cudaError_t of the launch, cudaErrorInvalidValue for what it
// does not take.
int hat_oca(const void* q, const void* kmap, const void* vmap,
            const void* bias, void* out, int B, int nh_w, int nw_w, int hp,
            int wp, int C, int nh, int ws, int ows, float scale, int plant,
            void* stream) {
  if (B < 1 || nh_w < 1 || nw_w < 1 || hp != nh_w * ws + ows - ws ||
      wp != nw_w * ws + ows - ws)
    return (int)cudaErrorInvalidValue;
  FlashArgs a = {};
  a.q = static_cast<const flash_tc::bf16*>(q);
  a.k = static_cast<const flash_tc::bf16*>(kmap);
  a.v = static_cast<const flash_tc::bf16*>(vmap);
  a.bias = static_cast<const float4*>(bias);
  a.out = static_cast<flash_tc::bf16*>(out);
  a.nh_w = nh_w;
  a.nw_w = nw_w;
  a.hp = hp;
  a.wp = wp;
  a.scale_log2 = scale * flash_tc::LOG2E;
  a.plant = plant;
  const long long nb = (long long)B * nh_w * nw_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plant)
    return nh == 6 && C == 120 && ws == 16 && ows == 24
               ? launch_oca<120, 6, 16, 24, true>(a, nb, s)
               : (int)cudaErrorInvalidValue;
  if (nh == 6 && C == 96 && ws == 8 && ows == 12)
    return launch_oca<96, 6, 8, 12>(a, nb, s);
  if (nh == 6 && C == 96 && ws == 8 && ows == 10)
    return launch_oca<96, 6, 8, 10>(a, nb, s);
  if (nh == 6 && C == 96 && ws == 16 && ows == 24)
    return launch_oca<96, 6, 16, 24>(a, nb, s);
  if (nh == 6 && C == 120 && ws == 16 && ows == 24)
    return launch_oca<120, 6, 16, 24>(a, nb, s);
  if (nh == 8 && C == 128 && ws == 8 && ows == 12)
    return launch_oca<128, 8, 8, 12>(a, nb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
