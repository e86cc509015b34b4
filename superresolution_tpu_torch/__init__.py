"""PyTorch/CUDA port of superresolution_tpu for one NVIDIA H100.

The JAX package `superresolution_tpu` is the reference; this package
mirrors its module names (models/, ops/, infer/, train/, ...) so each
counterpart is easy to find, and keeps its NHWC layout at every public
function.

Slice 1 covers the ESRGAN RRDBNet x4 tiled deploy path: the fused-trunk
dense blocks and the x4 tail run through hand-written CUDA kernels
(ops/csrc/sr_kernels.cu), built with nvcc at first use. Slice 2 covers
the hybrid RRDBNet -> HAT x4 deploy path (infer/fused_hat.py): the HAT
stage's CAB convs and HAB block bodies run through ops/csrc/
hat_kernels.cu and its OCAB attention through ops/csrc/oca_kernels.cu
(kernel 9), stage 1 through the slice-1 trunk. Slice 3
covers hybrid_astro training on one device (train/trainer.py): the dense
blocks' backward (kernel 13) and the star-weighted L1 (kernel 14) run
through ops/csrc/train_kernels.cu, their forwards through B1. Slice 4
covers the public API (api.upscale, with the host tiler of infer/tiled.py
or the on-device one of infer/tiled_device.py) over the hybrid with flash
window attention (kernel 10, ops/csrc/attn_kernels.cu), and loads
checkpoints for inference (train/checkpoint.load_params_for_inference).
Slice 5 runs the fused deploy models in both tilers, the HAT kernels at
window 16 and head dim 20, and the ESRGAN trunk's levers (fold_ends,
chain_rrdb) through kernels 4-6 (ops/csrc/sr_kernels.cu). Later slices
add the rest of the reference's presets and modules; among them GAN and
perceptual training (train/gan.py, models/discriminator.py,
losses/perceptual.py) and the command line, `python -m
superresolution_tpu_torch` (cli/main.py). Entry points
default to the `cuda` device and raise without a GPU unless the caller
passes device="cpu", where every kernel wrapper runs its plain PyTorch
version instead.
"""

from superresolution_tpu_torch.runtime import resolve_device  # noqa: F401
