// Kernel 10's tensor-core instances (flash_tc.cuh) at head dim 16 for the
// widths other than the model's (attn_tc_kernels.cu): C 16, 32, 48, 64, 80, 112
// (1-5 and 7 heads), on windows (any key count) and on the map (ws 8 and
// 16). A file of its own so that nvcc builds it beside the others.

#include "flash_tc.cuh"

namespace flash_tc {

int launch_width16(const FlashArgs& a, int mode, long long nb, int ws,
                   int nh, cudaStream_t s) {
  switch (nh) {
    case 1: return launch_width<16, 1>(a, mode, nb, ws, s);
    case 2: return launch_width<32, 2>(a, mode, nb, ws, s);
    case 3: return launch_width<48, 3>(a, mode, nb, ws, s);
    case 4: return launch_width<64, 4>(a, mode, nb, ws, s);
    case 5: return launch_width<80, 5>(a, mode, nb, ws, s);
    case 7: return launch_width<112, 7>(a, mode, nb, ws, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_tc
