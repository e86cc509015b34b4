"""Kernel 8 (ops/hab.py hab_kernel, the fused HAB window body) against
its bound: one call a HAB over stage 2's tokens, the stage-1 output of
the pixels a unit passes through the model (readers.roofline)."""

from portbench import readers
from portbench.counts import hab


def match(name: str) -> bool:
    return "hab_kernel" in name


def read(ctx):
    m = ctx.config["model"]
    if "stage2" not in m:
        return None
    h = m["stage2"]
    tokens = ctx.driver.model_pixels() * m["stage1"]["scale"] ** 2
    c, ws = h["embed_dim"], h["window_size"]
    return readers.roofline(ctx, match, sum(h["depths"]) * hab.call_bound_s(
        tokens, c, int(c * h["mlp_ratio"]), ws * ws))
