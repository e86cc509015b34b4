"""Mixed-precision policy: bf16 compute over f32 parameters.

Counterpart of superresolution_tpu/utils/precision.py. The train step
runs the model as torch.func.functional_call(model,
policy.cast_to_compute(params), x): every op sees bf16 weights, as every
op of the reference does, and gradients flow back through the cast to
the f32 masters. torch.autocast is a different policy (it keeps layer
norms, softmax and some reductions in f32 by its own list), so the port
does not use it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch


@dataclass(frozen=True)
class Policy:
    """Parameters stay f32; the forward computes in `compute_dtype`."""

    compute_dtype: torch.dtype = torch.bfloat16

    def cast_to_compute(self, tree: Mapping[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
        """Floating tensors of a name -> tensor dict to the compute type
        (differentiably); integer buffers stay as they are."""
        return {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                for k, v in tree.items()}


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def get_policy(name: str) -> Policy:
    if name in ("bf16", "bfloat16", "mixed"):
        return DEFAULT_POLICY
    if name in ("fp32", "float32", "full"):
        return FP32_POLICY
    raise ValueError(f"unknown precision policy {name!r}")
