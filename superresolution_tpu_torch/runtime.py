"""Device resolution and the kernel cache for the port's entry points.

Counterpart of superresolution_tpu/utils/runtime.py: the port runs on
the card unless the caller asks for the CPU, and never falls back to the
CPU silently; setup_kernel_cache stands where setup_jax_cache does.
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


def setup_kernel_cache(device: str | torch.device | None = None) -> None:
    """The counterpart of the reference's setup_jax_cache (called at the
    start of its CLI's main). The port compiles no programs at run time
    apart from its CUDA kernels, and their cache is already persistent:
    ops/_build.py builds one shared library with nvcc at first use into
    superresolution_tpu_torch/_build/, named by a hash of the sources and
    flags, and every later process loads it from there (a changed source
    builds a new one). So there is nothing to configure. The CLI's main
    calls this for a subcommand that takes --device: on the card the
    library is built (or found) before any work starts, so a missing
    nvcc or a build error stops the command at once and the build's
    seconds are not charged to the first frame or step; on the CPU the
    wrappers run their plain versions and nothing is built."""
    if resolve_device(device).type == "cuda":
        from superresolution_tpu_torch.ops import _build

        _build.build()
        _build.library()
