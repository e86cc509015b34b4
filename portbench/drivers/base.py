"""What the drivers share: the protocol the harness calls, device
events for per-stage device time, the port's model configuration built
from a benchmark configuration, and the weights and inputs of a run.

A driver's Driver(ctx) has
  setup()           the port built or found, weights and inputs made
                    from ctx.seed, every shape of the cell warmed up;
  run_unit(i)       one unit (frame, patch or step): returns (work, the
                    record a check may compare or None, a 0-d bool
                    tensor that is False when the output is not finite);
  sync_each         True when a unit ends with the result on the host's
                    side (a closed loop of requests), so its latency is
                    timed;
  tracing           set by the harness around the profiled stretch;
  after_trace()     readings of the stretch into ctx.extra;
  training          True when a unit is an optimizer step;
  model_pixels()    the input (LR) pixels a unit passes through the
                    model, halos and the whole batch included: what the
                    roofline readers count a kernel's work from;
  model_flops()     the model's forward FLOPs a unit (training: 3x);
  finish()          the port's state dropped, before the reference;
  check(records)    the numbers compared, by name (the cell's limits).
"""

from __future__ import annotations

import torch

from portbench import common


class Driver:
    sync_each = True
    training = False

    def __init__(self, ctx):
        self.ctx = ctx
        self.tracing = False
        self.seed = ctx.seed
        self.device = torch.device(ctx.device)
        self.events: dict = {}

    def subseed(self, tag: str) -> int:
        return common.subseed(self.seed, tag)

    def init(self) -> dict:
        """The output layer's init (weights.py): the cell's own where it
        states one, else the configuration's."""
        return self.ctx.cell["entry"].get(
            "init", self.ctx.config["assumed"]["init"])

    def timed(self, name: str, fn):
        """fn wrapped in a host span and, while tracing on the card, a
        pair of CUDA events whose device time after_trace reads."""
        def wrapped(*a, **kw):
            with self.ctx.span(name):
                if not (self.tracing and self.device.type == "cuda"):
                    return fn(*a, **kw)
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = fn(*a, **kw)
                t1.record()
                self.events.setdefault(name, []).append((t0, t1))
                return out

        return wrapped

    def event_ms(self, name: str) -> float | None:
        pairs = self.events.get(name)
        if not pairs:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs)

    def after_trace(self) -> None:
        pass

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def port_hybrid_config(cfg: dict, **stage2):
    """The port's ModelConfig for a hybrid configuration file, with
    stage-2 flags (flash_attn, attn_f32, remat) added."""
    from superresolution_tpu_torch.utils.config import ModelConfig

    s1, h = cfg["model"]["stage1"], cfg["model"]["stage2"]
    return ModelConfig(
        name="rrdbnet", scale=s1["scale"], in_channels=s1["num_in_ch"],
        out_channels=s1["num_out_ch"],
        kwargs={"features": s1["num_feat"], "num_blocks": s1["num_block"],
                "growth": s1["num_grow_ch"], "upsampler": s1["upsampler"],
                **({"remat": stage2["remat"]} if "remat" in stage2 else {})},
        refiner="hat_lite",
        refiner_kwargs={"scale": h["upscale"], "embed_dim": h["embed_dim"],
                        "depths": tuple(h["depths"]),
                        "num_heads": tuple(h["num_heads"]),
                        "window_size": h["window_size"],
                        "mlp_ratio": h["mlp_ratio"],
                        "conv_scale": h["conv_scale"],
                        "overlap_ratio": h["overlap_ratio"], **stage2},
        smoothing=cfg["model"]["smoothing"])


def hybrid_weights(drv: Driver, cfg: dict, first, dtype: torch.dtype
                   ) -> dict:
    """The hybrid's weights from the seed; where the init (Driver.init)
    says `fit`, each stage's output conv fitted on a 128^2 crop of
    `first`, the mix's first input (HWC numpy), by the plain reference."""
    from portbench.reference import models as R
    from portbench.weights import fit_hybrid, make_weights

    init = drv.init()
    p = make_weights(R.hybrid_specs(cfg), drv.subseed("weights"), init,
                     torch.float32, drv.device)
    if "fit" in init:
        probe = torch.from_numpy(first[:128, :128]).to(drv.device)[None]
        fit_hybrid(p, cfg, probe, init["fit"])
    return {k: v.to(dtype) for k, v in p.items()}

