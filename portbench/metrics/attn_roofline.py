"""Kernel 10 (ops/window_attention.py; flash_tc.cuh's flash_kernel body,
which kernel 9 shares) against its bound: the map form once a HAB and
the OCAB's gathered windows once a group, over stage 2's tokens
(readers.roofline)."""

from portbench import readers
from portbench.counts import attn


def match(name: str) -> bool:
    return "flash_kernel" in name


def read(ctx):
    m = ctx.config["model"]
    if "stage2" not in m:
        return None
    h = m["stage2"]
    c, ws, nh = h["embed_dim"], h["window_size"], h["num_heads"][0]
    ows = int(ws * (1 + h["overlap_ratio"]))
    tokens = ctx.driver.model_pixels() * m["stage1"]["scale"] ** 2
    bound = sum(h["depths"]) * attn.map_call_bound_s(tokens, c, nh, ws)
    bound += len(h["depths"]) * attn.window_call_bound_s(
        tokens // (ws * ws), c, nh, ws * ws, ows * ows)
    return readers.roofline(ctx, match, bound)
