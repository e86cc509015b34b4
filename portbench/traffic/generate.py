"""The one generator every traffic mix is read by.

A mix (portbench/traffic/<name>.json) is parameters only:

  kind      "photo_frames"     RGB frames on the device: band-limited
                               noise, the sum of octaves of smooth
                               random fields (a photo's spectrum, not
                               its content);
            "star_fields"      one-channel star fields on the host
                               (starfield.star_field), as float32 arrays;
            "star_pairs"       HR star fields and their observed LR
                               (starfield.observed_lr), as training pairs;
  height, width  the frame (star fields are square: `size`);
  scale     HR / LR of a pair;
  pool      distinct inputs made in set-up; the closed loop cycles
            through them in the order drawn from the seed, so every seed
            sends the same sizes.

Every input comes from the run's seed alone.
"""

from __future__ import annotations

import numpy as np
import torch


def photo_frames(t: dict, seed: int, device) -> list[torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    h, w, c = t["height"], t["width"], t.get("channels", 3)
    out = []
    for _ in range(t["pool"]):
        img = torch.zeros((1, c, h, w), device=device)
        for cell_px, amp in t["octaves"]:
            g = torch.rand((1, c, -(-h // cell_px) + 1, -(-w // cell_px) + 1),
                           generator=gen, device=device)
            img += amp * torch.nn.functional.interpolate(
                g, size=(h, w), mode="bilinear", align_corners=False)
        out.append(img[0].permute(1, 2, 0).clamp(0, 1).contiguous())
    return out


def star_fields(t: dict, seed: int) -> list[np.ndarray]:
    from portbench.traffic.starfield import star_field

    rng = np.random.default_rng(seed)
    return [star_field(rng, t["size"]) for _ in range(t["pool"])]


def star_pairs(t: dict, seed: int) -> list[tuple]:
    """[(lr [s/scale]^2, hr [s]^2)] float32 pairs."""
    from portbench.traffic.starfield import observed_lr, star_field

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(t["pool"]):
        hr = star_field(rng, t["size"])
        out.append((observed_lr(hr, t["scale"], rng), hr))
    return out


def order(n_pool: int, seed: int, n: int = 4096) -> list[int]:
    """The loop's order over the pool: each input once per pass, the
    passes shuffled from the seed."""
    rng = np.random.default_rng(seed)
    out: list[int] = []
    while len(out) < n:
        out += rng.permutation(n_pool).tolist()
    return out
