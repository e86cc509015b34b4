"""The share of device time in PyTorch's, cuDNN's and cuBLAS's kernels and
copies, not the port's hand kernels (whose names are the port's CUDA
sources', superresolution_tpu_torch/ops/csrc), over the profiled
stretch, in %. The glue is told by ATen's namespace and the prefixes
NVIDIA's libraries give their kernels."""

# PyTorch's ATen kernels, cuDNN's and cuBLAS's (CUTLASS and xmma
# templates, NVIDIA's gemm and conv kernel families)
GLUE_MARKS = ("at::native", "at::", "cudnn", "xmma", "cutlass", "gemm",
              "gemv", "Gemm", "sm90_", "sm80_", "ampere_", "hopper_",
              "nvjet", "cublas", "splitKreduce", "nchwToNhwc",
              "nhwcToNchw", "implicit_convolve", "conv2d_", "softmax_warp",
              "indexing_backward", "cunn_", "fft", "dgrad", "wgrad_engine",
              "convolve", "Memcpy", "Memset")


def read(ctx):
    tr = ctx.stretch
    if tr is None:
        return None
    evs = tr.kernels + tr.copies
    total = sum(d for _, _, d in evs)
    if total <= 0:
        return None
    return 100.0 * sum(d for n, _, d in evs
                       if any(m in n for m in GLUE_MARKS)) / total
