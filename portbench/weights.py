"""Random weights from the seed, made on the device in one draw.

Every parameter of a reference parameter list (reference/models.py
`*_specs`) is a view of one standard-normal draw from a device
generator, scaled by its init rule:

  msra (scale)  N(0, 2 / fan_in) * scale   (BasicSR's RRDB init: 0.1)
  lecun         N(0, 1 / fan_in)           (dense layers)
  normal (std)  N(0, std)                  (HAT's position tables)
  bias          N(0, bias_std)             (every bias, so each is used)
  ones          1 + N(0, bias_std)         (LayerNorm gains)
  out           N(0, 2 / fan_in) * out_gain, the output conv
  out_bias      out_bias + N(0, bias_std)

out_gain and out_bias (the configuration's `assumed.init`, one number
or one a stage, {"stage1": ..., "stage2": ...}), or a fit of the output
conv on a probe input (fit_output), give a random model's output the
range a trained model's has, a photo's about 0.5 +- 0.15: otherwise the
output spreads over hundreds, the clip after the model saturates nearly
every pixel, and the comparison sees little of the network. The values
are rounded to the served type once, and the port and the reference
read the same numbers.
"""

from __future__ import annotations

import math

import torch

BIAS_STD = 0.02


def _per_stage(value, name: str) -> float:
    return value[name.split(".", 1)[0]] if isinstance(value, dict) \
        else value


def make_weights(specs: list, seed: int, init: dict, dtype: torch.dtype,
                 device) -> dict[str, torch.Tensor]:
    """init: {"out_gain": ..., "out_bias": ...}."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, (rule, *arg) in specs:
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        if rule == "msra":
            v = v * (math.sqrt(2.0 / fan_in) * arg[0])
        elif rule == "lecun":
            v = v * math.sqrt(1.0 / fan_in)
        elif rule == "normal":
            v = v * arg[0]
        elif rule == "bias":
            v = v * BIAS_STD
        elif rule == "ones":
            v = 1.0 + v * BIAS_STD
        elif rule == "out":
            v = v * (math.sqrt(2.0 / fan_in)
                     * _per_stage(init["out_gain"], name))
        elif rule == "out_bias":
            v = _per_stage(init["out_bias"], name) + v * BIAS_STD
        else:
            raise ValueError(f"unknown init rule {rule!r} for {name}")
        out[name] = v.to(dtype)
    return out


def fit_output(p: dict, prefix: str, out: torch.Tensor, mean: float,
               std: float) -> None:
    """Rescale the output conv `prefix`conv_last in place so that `out`,
    the model's output on a probe from these weights, would have the
    given mean and standard deviation: W <- a W, b <- a (b - m) + mean,
    a = std / std(out)."""
    a = std / float(out.std())
    m = float(out.mean())
    w, b = f"{prefix}conv_last.weight", f"{prefix}conv_last.bias"
    p[w] = p[w] * a
    p[b] = (p[b] - m) * a + mean


def fit_hybrid(p: dict, cfg: dict, probe: torch.Tensor, fit: dict) -> None:
    """Each stage's output fitted in turn on a probe input (NHWC, f32), by
    the plain reference: stage 1 to fit["stage1"] = (mean, std), then
    stage 2, fed the blurred stage-1 output, to fit["stage2"]."""
    from portbench.reference import models as R
    from portbench.reference.ops import binomial_blur

    with torch.no_grad():
        y = R.rrdbnet(R.sub(p, "stage1."), cfg["stage1"], probe)
        fit_output(p, "stage1.", y, *fit["stage1"])
        y = binomial_blur(R.rrdbnet(R.sub(p, "stage1."), cfg["stage1"],
                                    probe), cfg["smoothing"])
        fit_output(p, "stage2.", R.hatlite(R.sub(p, "stage2."),
                                           cfg["stage2"], y),
                   *fit["stage2"])
