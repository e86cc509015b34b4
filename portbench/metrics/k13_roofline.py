"""Kernel 13's own kernels (ops/dense_trunk_train.py: the transposed
convs, the weight gradients and their reduces, the weight flip and the
scale; its recompute runs on B1's kernel) against their bound: one call
a dense block of a training step (readers.roofline)."""

from portbench import readers
from portbench.counts import k13

NAMES = ("DenseGradConv", "wgrad_tc_kernel", "wgrad_reduce_kernel",
         "wgrad_kernel", "flip_weights_kernel", "dense_scale_kernel")


def match(name: str) -> bool:
    return any(s in name for s in NAMES)


def read(ctx):
    if not ctx.driver.training:
        return None
    nb = readers.stage1(ctx)["num_block"]
    return readers.roofline(
        ctx, match, 3 * nb * k13.own_bound_s(ctx.driver.model_pixels()))
