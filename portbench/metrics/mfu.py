"""The whole model step's share of the card's bf16 peak, in %: the
model's FLOPs over the untraced window (forward, x3 for a training step;
the frames' own pixels, not the halo; counts/, by the driver) over its
seconds and counts/peaks.py's peak."""

from portbench.counts import peaks


def read(ctx):
    if not ctx.window_s:
        return None
    return 100.0 * ctx.window_units * ctx.driver.model_flops() / \
        ctx.window_s / peaks.BF16_FLOPS
