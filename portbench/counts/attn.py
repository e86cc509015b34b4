"""Kernel 10, window attention on the tensor cores
(ops/window_attention.py): 4 n m hd FLOP a window and head (q k^T and
the weighted sum of v)."""

from portbench.counts.peaks import bound_s


def flops(windows: int, heads: int, n: int, m: int, hd: int) -> float:
    return 4.0 * windows * heads * n * m * hd


def map_call_bound_s(pixels: int, c: int, heads: int, ws: int) -> float:
    """The map form (a HAB's self-attention): the qkv map read, the
    output map written, bf16."""
    n = ws * ws
    return bound_s(flops(pixels // n, heads, n, n, c // heads),
                   2 * pixels * 4 * c)


def window_call_bound_s(windows: int, c: int, heads: int, n: int, m: int
                        ) -> float:
    """Gathered windows (the OCAB): q [n, C], k and v [m, C] read, the
    output [n, C] written, bf16."""
    return bound_s(flops(windows, heads, n, m, c // heads),
                   2 * windows * c * (2 * n + 2 * m))
