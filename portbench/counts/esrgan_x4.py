"""Forward MACs of ESRGAN's RRDBNet per input (LR) pixel: conv_first,
the 3 x num_block dense blocks, conv_body, then the x4 tail as two
conv + shuffle stages, conv_hr and conv_last at HR; about 17.93 M at
the published widths."""

from portbench.counts import b1


def macs_per_lr_pixel(m: dict) -> int:
    c, g = m["num_feat"], m["num_grow_ch"]
    macs = 9 * m["num_in_ch"] * c
    macs += 3 * m["num_block"] * b1.macs_per_pixel(c, g)
    macs += 9 * c * c
    area = 1
    for _ in range({2: 1, 4: 2, 8: 3}[m["scale"]]):
        macs += area * 9 * c * 4 * c       # conv_up{n} at its input size
        area *= 4
    macs += area * 9 * c * c                # conv_hr
    macs += area * 9 * c * m["num_out_ch"]  # conv_last
    return macs
