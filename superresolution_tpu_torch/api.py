"""Top-level public API: `upscale` and `build_model`.

Counterpart of superresolution_tpu/api.py. upscale runs overlap-halo
tiled inference, either with the host tiler (infer/tiled.py: the image
stays on the host and each batch of tiles goes to the device and back,
for images larger than device memory) or, with on_device=True, with the
image, the tiles and the output on the device (infer/tiled_device.py),
the serving path.
"""

from __future__ import annotations

import torch


def build_model(name: str, **kwargs) -> torch.nn.Module:
    """Construct an SR model by registry name (models/factory.py)."""
    from superresolution_tpu_torch.models.factory import get_model

    return get_model(name, **kwargs)


def upscale(img, scale: int = 4, *, model=None, params=None,
            tile: int = 256, halo: int = 16, on_device: bool = False,
            **kwargs):
    """Super-resolve an HWC (or HW) image array in [0, 1] by `scale`.

    `model` is an nn.Module of the port, a registry name, None
    ('rrdbnet') or a PreboundModel (infer/fused_trunk.fused_rrdb_model,
    infer/fused_hat.fused_hybrid_model), which ignores `params`;
    `params` the module's state dict (None: its random initialization).
    Options of both tilers: batch (8), precision
    ('bf16') and device (default cuda); the host tiler also takes blend
    and pad_mode. Any other keyword goes to the model's constructor.

    on_device=False (default): the host tiler; returns f32 numpy.
    on_device=True: the image, the tiles and the output stay on the
    device, with exact crop blending and edge padding; returns an f32
    tensor on the device."""
    if not on_device:
        from superresolution_tpu_torch.infer.tiled import upscale as _up

        return _up(img, scale, model=model, params=params, tile=tile,
                   halo=halo, **kwargs)

    from superresolution_tpu_torch.infer.tiled import _default_model_params
    from superresolution_tpu_torch.infer.tiled_device import (
        upscale_on_device)
    from superresolution_tpu_torch.runtime import resolve_device
    from superresolution_tpu_torch.utils.precision import get_policy

    # host-tiler options must not leak into the model constructor
    batch = kwargs.pop("batch", 8)
    precision = kwargs.pop("precision", "bf16")
    device = kwargs.pop("device", None)
    for k in ("blend", "pad_mode"):
        if k in kwargs:
            raise ValueError(
                f"{k!r} applies to the host tiler only (the on-device"
                " path always uses exact crop blending)")
    dev = resolve_device(device)
    arr = torch.as_tensor(img, device=dev)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    model, params = _default_model_params(arr, scale, model, params,
                                          device=dev, **kwargs)
    out = upscale_on_device(arr, scale, model, params, tile=tile, halo=halo,
                            batch=batch,
                            compute_dtype=get_policy(precision).compute_dtype,
                            device=dev)
    return out[..., 0] if squeeze else out
