"""infer_mp_s: input megapixels upscaled per second over the whole
window: every unit the window finished, over all of its time (host
clock, each unit ending when its output is on the device)."""


def read(ctx):
    return ctx.work / ctx.window_s if ctx.window_s else None
