"""Device resolution for the port's entry points.

Counterpart of superresolution_tpu/utils/runtime.py, device part only:
the port runs on the card unless the caller asks for the CPU, and never
falls back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> cuda. Raises when cuda is asked for and no GPU is present;
    device="cpu" is the explicit opt-in the tests use."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def exact_fp32_reference() -> None:
    """Make float32 convs and matmuls on the card run in full float32
    (cuDNN defaults to TF32 for convs), so a plain version can serve as
    the reference a kernel is held against."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
