"""setup_s: seconds from the start of the run to the first unit: the
port loaded and its kernel library built or found, weights and inputs
made, every shape warmed up (host clock)."""


def read(ctx):
    return ctx.setup_s
