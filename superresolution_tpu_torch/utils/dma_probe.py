"""Kernel 19: the device-memory passthrough probe.

Counterpart of bench.py:dma_probe and its local make_pt (a Pallas copy,
one grid step per band of rb rows), which the reference used to time its
chip's copy rate at two layouts of equal bytes. On CUDA tensors the copy
is the hand-written copy_kernel (ops/csrc/stream_kernels.cu): one block
for each COPY_CHUNK bytes of the buffer (copy_grid), one 16-byte load
and store a thread. The reference's
band grid of rb rows is its TPU's layout, not the contract: rb is
checked as the reference checks it, and names the band a planted fault
leaves unwritten. On CPU tensors it is the plain x.clone().

The numbers it gives are the card's measured copy rate, beside the
nominal 3.35 TB/s of an H100 SXM that the port's bounds use.
"""

from __future__ import annotations

import torch

from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.runtime import resolve_device

# The reference's two shapes: the ESRGAN trunk's operand class [24, 376,
# 272, 64] bf16 at rb 94, and the same bytes as [24, 376, 136, 128].
PROBE_SHAPES = (("lane64", (24, 376, 272, 64)),
                ("lane128", (24, 376, 136, 128)))
PROBE_RB = 94
PROBE_ITERS = 10  # timed copies a shape, as the reference's probe
# clock cycles the card spins before a timed span (~25 ms at 2 GHz): far
# longer than the host takes to issue the span's calls
SPIN_CYCLES = 50_000_000
WORD = 16         # bytes a load or store of the kernel moves
# a block's chunk: a word for each of copy_kernel's 1024 threads
COPY_CHUNK = 1024 * WORD


def copy_grid(nbytes: int) -> int:
    """Kernel 19's grid for a copy of nbytes (a multiple of WORD): one
    block a chunk, block b copying bytes [b COPY_CHUNK, (b + 1)
    COPY_CHUNK) of them."""
    return max(1, -(-nbytes // COPY_CHUNK))


def passthrough_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: a copy."""
    return x.clone()


def passthrough(x: torch.Tensor, rb: int) -> torch.Tensor:
    """Kernel 19: a copy of x [B, H, W, C] through copy_kernel, on
    copy_grid's grid. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise. Raises ValueError when H % rb != 0 or a
    band of rb rows is not a whole number of 16-byte words."""
    if x.ndim != 4:
        raise ValueError(f"passthrough: [B, H, W, C] expected, got shape "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    if rb < 1 or h % rb:
        raise ValueError(f"H={h} not a multiple of row band {rb}")
    if x.device.type == "cpu":
        return passthrough_reference(x)
    band_bytes = rb * w * c * x.element_size()
    if band_bytes % WORD:
        raise ValueError(f"passthrough: a band of {band_bytes} bytes is not "
                         f"a multiple of 16")
    x = x.contiguous()
    _build.require_cuda(x, dtype=x.dtype, name="passthrough")
    out = torch.empty_like(x)
    _build.stream_copy(x, out, copy_grid(b * (h // rb) * band_bytes),
                       band_bytes)
    passthrough.launches += 1
    return out


passthrough.launches = 0


def make_pt(shape, rb: int):
    """The reference's make_pt: a function copying x of `shape` through
    kernel 19. Raises ValueError when H % rb != 0."""
    b, h, w, c = shape
    if rb < 1 or h % rb:
        raise ValueError(f"H={h} not a multiple of row band {rb}")

    def apply(x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"make_pt: built for {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        return passthrough(x, rb)

    return apply


def copy_ms(fn, x: torch.Tensor, iters: int = PROBE_ITERS) -> float:
    """Mean device ms of fn(x) over `iters` calls after one warm-up (CUDA
    events). The calls are queued behind a spin of the card, so the span
    holds the card's time alone and not the host's time to issue them:
    a call of kernel 19's wrapper takes the host tens of microseconds,
    which the first call of an unqueued span adds to it."""
    fn(x)
    torch.cuda.synchronize(x.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    torch.cuda.synchronize(x.device)
    return start.elapsed_time(end) / iters


def dma_probe(device: str | torch.device | None = None) -> dict:
    """The copy rate through kernel 19 at the reference's two shapes, in
    GB/s of bytes read plus written, under the reference's keys:
    dma_gbps_lane64, dma_gbps_lane128 and dma_lane64_over_lane128. The
    names are the reference's; a GPU has no lanes, and the two shapes
    differ here only in how many channels a pixel holds. Measures the
    card only: raises for a CPU device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("dma_probe measures the card; it has no CPU "
                         "version")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for tag, shape in PROBE_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        ms = copy_ms(make_pt(shape, PROBE_RB), x)
        out[f"dma_gbps_{tag}"] = 2 * x.numel() * x.element_size() / 1e9 / (
            ms / 1e3)
        del x
    out["dma_lane64_over_lane128"] = (out["dma_gbps_lane64"]
                                      / max(out["dma_gbps_lane128"], 1e-9))
    return out
