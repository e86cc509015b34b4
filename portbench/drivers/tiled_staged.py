"""ESRGAN x4 through the staged on-device tiler: the 2K frame cut into
tiles with a halo, the trunk on kernel B1 over all tiles at once
(infer/fused_trunk.make_fused_trunk), the x4 tail on kernels B2 and B3
in chunks (infer/phase_tail.make_phase_tail, clipped), reassembled by
infer/tiled_device.make_tiled_infer_staged. One unit is one frame."""

from __future__ import annotations

import torch

from portbench.drivers import base
from portbench.reference import models as R
from portbench.reference.compare import image_gap, tiled, worst
from portbench.reference.ops import F32
from portbench.traffic import generate
from portbench.weights import make_weights


class Driver(base.Driver):
    def setup(self) -> None:
        from superresolution_tpu_torch.infer.fused_trunk import (
            make_fused_trunk)
        from superresolution_tpu_torch.infer.phase_tail import (
            make_phase_tail)
        from superresolution_tpu_torch.infer.tiled_device import (
            make_tiled_infer_staged)
        from superresolution_tpu_torch.models.rrdbnet import RRDBNet
        from superresolution_tpu_torch.runtime import setup_kernel_cache

        ctx, dev = self.ctx, self.device
        setup_kernel_cache(dev)
        self.m = m = ctx.config["model"]
        self.e = e = ctx.cell["entry"]
        t = ctx.traffic
        self.params = make_weights(
            R.rrdbnet_specs(m), self.subseed("weights"),
            self.init(), torch.bfloat16, dev)
        # the port's model object gives the trunk its configuration; its
        # own random parameters are not used
        model = RRDBNet(scale=m["scale"], in_channels=m["num_in_ch"],
                        out_channels=m["num_out_ch"], features=m["num_feat"],
                        num_blocks=m["num_block"], growth=m["num_grow_ch"],
                        upsampler=m["upsampler"], device="cpu")
        trunk = make_fused_trunk(self.params, model, device=dev)
        tail = make_phase_tail(self.params, device=dev)
        self.frames = generate.photo_frames(t, self.subseed("inputs"), dev)
        self.order = generate.order(len(self.frames), self.subseed("order"))
        self.hw = (t["height"], t["width"])
        self.run = make_tiled_infer_staged(
            self.timed("trunk", lambda x: trunk(x.to(torch.bfloat16))),
            self.timed("tail", tail), scale=m["scale"],
            tile=tuple(e["tile"]), halo=e["halo"],
            tail_batch=e["tail_batch"], h=t["height"], w=t["width"],
            channels=t["channels"], device=dev)
        self.run(self.frames[0])  # the cell's one shape

    def run_unit(self, i: int):
        k = self.order[i % len(self.order)]
        with self.ctx.span("frame"):
            out = self.run(self.frames[k])
        return self.hw[0] * self.hw[1] / 1e6, (k, out), \
            torch.isfinite(out).all()

    def model_flops(self) -> float:
        from portbench.counts import esrgan_x4

        return 2.0 * esrgan_x4.macs_per_lr_pixel(self.m) * self.hw[0] * \
            self.hw[1]

    def model_pixels(self) -> int:
        """Every tile of the frame with its halo."""
        th, tw = self.e["tile"]
        return (-(-self.hw[0] // th) * -(-self.hw[1] // tw)
                * (th + 2 * self.e["halo"]) * (tw + 2 * self.e["halo"]))

    def after_trace(self) -> None:
        n = self.ctx.stretch_units
        for k in ("trunk", "tail"):
            ms = self.event_ms(k)
            if ms is not None:
                self.ctx.extra[f"{k}_ms"] = ms / n

    def finish(self) -> None:
        self.run = None
        super().finish()

    def reference(self, k: int, pr=F32) -> torch.Tensor:
        p = {n: v.float() for n, v in self.params.items()}
        return tiled(lambda t: R.rrdbnet(p, self.m, t, pr).clamp(0.0, 1.0),
                     self.frames[k], self.m["scale"], tuple(self.e["tile"]),
                     self.e["halo"], batch=2)

    def check(self, records: list) -> dict:
        return worst([image_gap(out, self.reference(k))
                      for k, out in records])
