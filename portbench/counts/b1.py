"""Kernel B1, the fused dense block (ops/dense_trunk.fused_dense_block):
five 3x3 convs, conv j reading x and the j-1 growth maps before it.
At C 64, growth 32: 239,616 MACs a pixel (PERF.md's kernel table)."""

from portbench.counts.peaks import bound_s

C, G = 64, 32


def macs_per_pixel(c: int = C, g: int = G) -> int:
    return 9 * sum((c + j * g) * (g if j < 4 else c) for j in range(5))


def recompute_macs_per_pixel(c: int = C, g: int = G) -> int:
    """Convs 1-4 again: what kernel 13's backward recomputes on B1."""
    return 9 * sum((c + j * g) * g for j in range(4))


def call_bound_s(pixels: int, residual: bool = False, c: int = C,
                 g: int = G) -> float:
    """One call over `pixels` bf16 pixels: x read, the output written,
    the residual read when folded in, the weights once."""
    weights = 2 * macs_per_pixel(c, g)  # one bf16 weight a MAC a pixel
    nbytes = 2 * pixels * c * (3 if residual else 2) + weights
    return bound_s(2.0 * macs_per_pixel(c, g) * pixels, nbytes)


def trunk_bound_s(num_block: int, pixels: int, c: int = C, g: int = G
                  ) -> float:
    """One trunk pass of 3 x num_block calls over `pixels` pixels (every
    third call reads the RRDB's residual)."""
    return num_block * (2 * call_bound_s(pixels, c=c, g=g)
                        + call_bound_s(pixels, residual=True, c=c, g=g))


def recompute_bound_s(pixels: int, c: int = C, g: int = G) -> float:
    """Kernel 13's recompute of convs 1-4 on B1's kernel, one dense block:
    x and the 4 growth maps (bf16) read and written once."""
    return bound_s(2.0 * recompute_macs_per_pixel(c, g) * pixels,
                   2 * pixels * 4 * c)
