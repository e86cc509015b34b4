"""The share of the window in which no kernel, copy or set ran on the
card, in %: the device's busy seconds a unit in the profiled stretch
(the union of the device intervals, not a sum of self times) over the
seconds a unit of the untraced window. The profiler's own host cost
(CUPTI records every launch, some 10-15 us a launch) lengthens a
host-bound stretch but not the device's work, so the stretch's own idle
share (the `device` entry's busy_s and window_s) overstates a
host-bound cell's. Within the two clocks' noise (about +-0.5%) a cell
that keeps the card busy can read a little under 0."""


def read(ctx):
    tr = ctx.stretch
    if tr is None or not ctx.stretch_units or not ctx.window_units:
        return None
    busy = tr.busy_s / ctx.stretch_units
    return 100.0 * (1.0 - busy / (ctx.window_s / ctx.window_units))
