"""Kernel 8, the fused HAB window body (ops/hab.py hab_kernel): LN, qkv,
window attention, proj, LN, MLP per token: C(4C + 2 MLP) + 2nC MACs a
token (PERF.md's kernel table)."""

from portbench.counts.peaks import bound_s


def macs_per_token(c: int, mlp: int, n: int) -> int:
    return c * (4 * c + 2 * mlp) + 2 * n * c


def call_bound_s(tokens: int, c: int, mlp: int, n: int) -> float:
    """x and the CAB branch read, the output written (bf16)."""
    return bound_s(2.0 * macs_per_token(c, mlp, n) * tokens,
                   2 * tokens * 3 * c)
