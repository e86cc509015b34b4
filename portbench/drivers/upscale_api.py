"""The public API on whole frames: api.upscale(on_device=True) over the
hybrid as plain modules (stage 2's window attention on kernel 10 with
flash_attn, bf16 logits elsewhere), the frame cut into tiles with a
halo by infer/tiled_device.py, batches of tiles through the model, the
output clipped and left on the device. One unit is one frame."""

from __future__ import annotations

import torch

from portbench.drivers import base
from portbench.reference import models as R
from portbench.reference.compare import image_gap, tiled, worst
from portbench.reference.ops import F32
from portbench.traffic import generate


class Driver(base.Driver):
    def setup(self) -> None:
        from superresolution_tpu_torch import api
        from superresolution_tpu_torch.models.factory import (
            build_from_config)
        from superresolution_tpu_torch.runtime import setup_kernel_cache

        ctx, dev = self.ctx, self.device
        setup_kernel_cache(dev)
        self.cfg = ctx.config["model"]
        self.e = e = ctx.cell["entry"]
        model = build_from_config(
            base.port_hybrid_config(ctx.config, **e["attention"]),
            output_size=None, device=dev)
        self.frames = generate.star_fields(ctx.traffic,
                                           self.subseed("inputs"))
        self.params = base.hybrid_weights(self, self.cfg, self.frames[0],
                                          torch.bfloat16)
        self.order = generate.order(len(self.frames), self.subseed("order"))
        self.size = ctx.traffic["size"]
        self.scale = self.cfg["stage1"]["scale"] * self.cfg["stage2"][
            "upscale"]

        def upscale(img):
            return api.upscale(img[..., 0], self.scale, model=model,
                               params=self.params, tile=e["tile"],
                               halo=e["halo"], batch=e["batch"],
                               on_device=True, device=dev)

        self.upscale = upscale
        self.upscale(self.frames[0])

    def run_unit(self, i: int):
        k = self.order[i % len(self.order)]
        with self.ctx.span("frame"):
            out = self.upscale(self.frames[k])
        return self.size ** 2 / 1e6, (k, out), torch.isfinite(out).all()

    def model_flops(self) -> float:
        from portbench.counts import hybrid_astro

        return 2.0 * hybrid_astro.macs_per_lr_pixel(self.cfg) * self.size ** 2

    def model_pixels(self) -> int:
        """Every batch of tiles with their halos, the last batch filled
        out to the batch size as the tiler runs it."""
        e = self.e
        tiles = (-(-self.size // e["tile"])) ** 2
        batches = -(-tiles // e["batch"])
        return batches * e["batch"] * (e["tile"] + 2 * e["halo"]) ** 2

    def finish(self) -> None:
        self.upscale = None
        super().finish()

    def reference(self, k: int, pr=F32) -> torch.Tensor:
        p = {n: v.float() for n, v in self.params.items()}
        img = torch.from_numpy(self.frames[k]).to(self.device)
        return tiled(lambda t: R.hybrid(p, self.cfg, t, None, pr).clamp(
                         0.0, 1.0), img, self.scale, self.e["tile"],
                     self.e["halo"], batch=1)[..., 0]

    def check(self, records: list) -> dict:
        return worst([image_gap(out, self.reference(k))
                      for k, out in records])
