"""Device ms a frame of the trunk stage (kernel B1 and the convs around
it): CUDA events around the benchmark's wrapper of the trunk_fn it
hands the staged tiler, over the profiled stretch."""


def read(ctx):
    return ctx.extra.get("trunk_ms")
