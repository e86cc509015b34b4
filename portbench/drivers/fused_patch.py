"""The hybrid's deploy form on single patches: infer/fused_hat.
fused_hybrid_model (stage 1 on kernel B1 and its tail, the blur, stage
2 on kernels 7, 8 and 9, the blurs), one 128^2 star-field cutout a
request, the patch sent from the host and its 512^2 output left on the
device. One unit is one patch."""

from __future__ import annotations

import torch

from portbench.drivers import base
from portbench.reference import models as R
from portbench.reference.compare import image_gap, worst
from portbench.reference.ops import F32
from portbench.traffic import generate


class Driver(base.Driver):
    def setup(self) -> None:
        from superresolution_tpu_torch.infer.fused_hat import (
            fused_hybrid_model)
        from superresolution_tpu_torch.models.factory import (
            build_from_config)
        from superresolution_tpu_torch.runtime import setup_kernel_cache

        ctx, dev = self.ctx, self.device
        setup_kernel_cache(dev)
        self.cfg = ctx.config["model"]
        self.out_size = ctx.cell["entry"]["output_size"]
        # the port's model object gives the deploy form its configuration;
        # its own random parameters are not used
        model = build_from_config(base.port_hybrid_config(ctx.config),
                                  output_size=self.out_size, device="cpu")
        fields = generate.star_fields(ctx.traffic, self.subseed("inputs"))
        self.params = base.hybrid_weights(self, self.cfg, fields[0],
                                          torch.bfloat16)
        self.model = fused_hybrid_model(self.params, model, device=dev)
        pin = dev.type == "cuda"
        self.patches = [torch.from_numpy(a[None]).pin_memory() if pin
                        else torch.from_numpy(a[None]) for a in fields]
        self.order = generate.order(len(self.patches),
                                    self.subseed("order"))
        self.size = ctx.traffic["size"]
        with torch.inference_mode():
            self.model(self.patches[0].to(dev, torch.bfloat16))

    def run_unit(self, i: int):
        k = self.order[i % len(self.order)]
        with self.ctx.span("patch"), torch.inference_mode():
            x = self.patches[k].to(self.device, non_blocking=True)
            out = self.model(x.to(torch.bfloat16))
        return self.size ** 2 / 1e6, (k, out), torch.isfinite(out).all()

    def model_flops(self) -> float:
        from portbench.counts import hybrid_astro

        return 2.0 * hybrid_astro.macs_per_lr_pixel(self.cfg) * self.size ** 2

    def model_pixels(self) -> int:
        return self.size ** 2

    def finish(self) -> None:
        self.model = None
        super().finish()

    def reference(self, k: int, pr=F32) -> torch.Tensor:
        p = {n: v.float() for n, v in self.params.items()}
        x = self.patches[k].to(self.device)
        return R.hybrid(p, self.cfg, x, self.out_size, pr)

    def check(self, records: list) -> dict:
        return worst([image_gap(out, self.reference(k))
                      for k, out in records])
