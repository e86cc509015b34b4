"""Device ms a frame of the x4 tail (kernels B2, B3 and conv_up1):
CUDA events around the benchmark's wrapper of the tail_fn, over the
profiled stretch."""


def read(ctx):
    return ctx.extra.get("tail_ms")
