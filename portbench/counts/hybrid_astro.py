"""Forward MACs of the hybrid per input (LR) pixel: the RRDBNet stage at
LR and HR x2 (nearest + conv upsampler), then the HATLite stage on the
x2 map: per HAB token the window body (counts.hab) and the CAB convs,
per OCAB token its dense layers, MLP and cross-attention, a conv per
group, conv_after_body, the x2 upsample conv and conv_last. The
binomial blurs (25 and 9 MACs a pixel) are left out; about 35.1 M at
the published widths."""

from portbench.counts import b1, hab


def stage1_macs_per_pixel(m: dict) -> int:
    c, g = m["num_feat"], m["num_grow_ch"]
    up = m["scale"]
    macs = 9 * m["num_in_ch"] * c + 3 * m["num_block"] * b1.macs_per_pixel(
        c, g) + 9 * c * c
    area = up * up                      # nearest x2 then conv_up1 at HR
    macs += area * 9 * c * c            # conv_up1
    macs += area * 9 * c * c            # conv_hr
    macs += area * 9 * c * m["num_out_ch"]
    return macs


def stage2_macs_per_token(h: dict) -> int:
    c, ws = h["embed_dim"], h["window_size"]
    mlp = int(c * h["mlp_ratio"])
    mid = c // h["compress_ratio"]
    ows = int(ws * (1 + h["overlap_ratio"]))
    per_hab = hab.macs_per_token(c, mlp, ws * ws) + 9 * c * mid * 2
    per_ocab = 3 * c * c + c * c + 2 * c * 2 * c + 2 * ows * ows * c
    macs = 9 * h["in_chans"] * c
    macs += sum(h["depths"]) * per_hab
    macs += len(h["depths"]) * (per_ocab + 9 * c * c)
    macs += 9 * c * c                              # conv_after_body
    macs += 9 * c * 4 * c                          # upsample conv
    macs += 4 * 9 * c * h["in_chans"]              # conv_last at x2
    return macs


def macs_per_lr_pixel(cfg: dict) -> int:
    s1 = cfg["stage1"]
    return stage1_macs_per_pixel(s1) + s1["scale"] ** 2 * \
        stage2_macs_per_token(cfg["stage2"])
