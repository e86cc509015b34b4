"""Kernel B1 (ops/dense_trunk.py: the conv engine under the DenseConv
policy) against its bound: 3 x num_block calls a trunk pass over the
pixels a unit passes through the model (every third call reads the
RRDB's residual); in a training step also kernel 13's recompute of
convs 1-4, which runs on B1's kernel (readers.roofline)."""

from portbench import readers
from portbench.counts import b1


def match(name: str) -> bool:
    return "DenseConv" in name


def bound_s(ctx) -> float:
    nb = readers.stage1(ctx)["num_block"]
    px = ctx.driver.model_pixels()
    s = b1.trunk_bound_s(nb, px)
    if ctx.driver.training:
        s += 3 * nb * b1.recompute_bound_s(px)
    return s


def read(ctx):
    return readers.roofline(ctx, match, bound_s(ctx))
