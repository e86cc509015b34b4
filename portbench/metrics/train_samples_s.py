"""train_samples_s: training samples of completed optimizer steps per
second over the whole window (host clock; the window ends when the
card has finished its last step)."""


def read(ctx):
    return ctx.work / ctx.window_s if ctx.window_s else None
