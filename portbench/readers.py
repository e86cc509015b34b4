"""What the roofline readers (metrics/<kernel>_roofline.py) share: a
kernel's share of its bound over the profiled stretch."""

from __future__ import annotations


def roofline(ctx, match, bound_s_per_unit) -> float | None:
    """The bound of the stretch's units (`bound_s_per_unit`: the larger of
    the kernel's FLOPs at the bf16 peak and its bytes at the HBM peak a
    unit, counts/) over the device time of the kernels whose names
    `match` accepts in the profiled stretch, in %. None where the
    stretch ran none of them or the cell's shapes give no bound."""
    tr = ctx.stretch
    if tr is None or bound_s_per_unit is None:
        return None
    t, n = tr.kernel_seconds(match)
    if not n or not t:
        return None
    return 100.0 * bound_s_per_unit * ctx.stretch_units / t


def stage1(ctx) -> dict:
    """The RRDBNet the kernels of the trunk run: the configuration's
    model, or its first stage."""
    m = ctx.config["model"]
    return m.get("stage1", m)
