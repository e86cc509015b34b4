"""Kernel 13, the dense block's backward (ops/dense_trunk_train.py): the
data gradient (the five convs transposed) and the weight gradients, each
as many MACs as the forward, and the recompute of convs 1-4 on B1's
kernel: 608,256 MACs a pixel at C 64, growth 32 (PERF.md's kernel
table). The recompute runs on B1's kernels, so the benchmark counts it
with B1's device time; kernel 13's own kernels do `own_macs_per_pixel`."""

from portbench.counts import b1
from portbench.counts.peaks import bound_s


def macs_per_pixel(c: int = b1.C, g: int = b1.G) -> int:
    return 2 * b1.macs_per_pixel(c, g) + b1.recompute_macs_per_pixel(c, g)


def own_macs_per_pixel(c: int = b1.C, g: int = b1.G) -> int:
    return 2 * b1.macs_per_pixel(c, g)


def own_bound_s(pixels: int, c: int = b1.C, g: int = b1.G) -> float:
    """x, the workspace of convs 1-4's outputs and dout read, dx written
    (bf16), dW and db written (f32)."""
    ws = 4 * g
    nbytes = 2 * pixels * (c + ws + c + c) + 4 * b1.macs_per_pixel(c, g)
    return bound_s(2.0 * own_macs_per_pixel(c, g) * pixels, nbytes)
