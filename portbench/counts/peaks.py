"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the
700 W power limit): the denominators of every roofline and MFU share."""

BF16_FLOPS = 989e12     # bf16 / fp16 tensor cores
F32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES = 3.35e12     # HBM3 bytes per second


def bound_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS
            ) -> float:
    """The least time the card could take: the larger of the operations
    at peak FLOP/s and the bytes (each input read once, each output
    written once) at peak bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
