"""Host ms a step that the loop waited for the Trainer's loader to hand
over the next batch (host clock around the fetch, over the window)."""


def read(ctx):
    return ctx.extra.get("data_wait_ms")
