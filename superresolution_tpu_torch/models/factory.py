"""Build a generator from a ModelConfig, including the two-stage hybrid.

Counterpart of superresolution_tpu/models/factory.py:11-38, over the
generators of the reference's registry (superresolution_tpu/models/
__init__.py): SRCNN, ESPCN, FSRCNN, EDSR, RRDBNet and HATLite.
"""

from __future__ import annotations

import torch

from superresolution_tpu_torch.models.edsr import EDSR
from superresolution_tpu_torch.models.espcn import ESPCN
from superresolution_tpu_torch.models.fsrcnn import FSRCNN
from superresolution_tpu_torch.models.hat_lite import HATLite
from superresolution_tpu_torch.models.hybrid import HybridSR
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.models.srcnn import SRCNN
from superresolution_tpu_torch.utils.config import ModelConfig

_MODELS = {"srcnn": SRCNN, "espcn": ESPCN, "fsrcnn": FSRCNN, "edsr": EDSR,
           "rrdbnet": RRDBNet, "hat_lite": HATLite}


def total_scale(mc: ModelConfig) -> int:
    s = mc.scale
    if mc.refiner:
        # HATLite's own default scale when refiner_kwargs omits it
        s *= mc.refiner_kwargs.get("scale", 2)
    return s


def _tuplify(kw: dict) -> dict:
    """JSON round-trips turn tuples into lists; the models want tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}


def get_model(name: str, **kwargs) -> torch.nn.Module:
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(_MODELS)}")
    return _MODELS[name](**kwargs)


def build_from_config(mc: ModelConfig, output_size: int | None = None,
                      device: str | torch.device | None = None,
                      generator: torch.Generator | None = None
                      ) -> torch.nn.Module:
    """The model `mc` names, with the JAX package's defaults, its
    parameters made from `generator` and placed on `device` (default
    cuda; raises without a GPU unless device='cpu')."""
    common = dict(device=device, generator=generator)
    stage1 = get_model(mc.name, scale=mc.scale, in_channels=mc.in_channels,
                       out_channels=mc.out_channels, **_tuplify(mc.kwargs),
                       **common)
    if mc.refiner is None and mc.smoothing in (None, "none"):
        return stage1
    stage2 = None
    if mc.refiner is not None:
        stage2 = get_model(mc.refiner, in_channels=mc.out_channels,
                           out_channels=mc.out_channels,
                           **_tuplify(mc.refiner_kwargs), **common)
    return HybridSR(stage1=stage1, stage2=stage2, output_size=output_size,
                    smoothing=mc.smoothing)
