"""CUDA kernels launched a unit (frame or patch) in the profiled
stretch: the host dispatch of the model, a count."""


def read(ctx):
    tr = ctx.stretch
    if tr is None or not ctx.stretch_units:
        return None
    return len(tr.kernels) / ctx.stretch_units
