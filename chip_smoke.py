#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

The path is ESRGAN RRDBNet x4 (features 64, 23 RRDBs, growth 32,
pixelshuffle) over a 1080x1920 image in 360x240 tiles with halo 8, in
bf16, with random weights from a seed: the fused trunk (kernel B1, 69
dense blocks) over all 24 tiles at once, then the x4 tail (kernels B2 and
B3) in chunks of TAIL_BATCH tiles. The kernels are built from
superresolution_tpu_torch/ops/csrc/ at the start.

Phases, each printing one JSON line; any failure raises, so the exit code
is not 0:
  1 env      torch / CUDA versions, the card's name and power limit
  2 build    nvcc build of the kernels, seconds; the registers and
             spills of the conv engine (policies of B1, B2, 13's
             transposed convs, 15, 16, 18), kernels 17, B3, 9 and 19 (none
             may spill), kernel 6's rrdb_tc_kernel (may not spill), 13's
             wgrad_tc_kernel and flip_weights_kernel, and kernels 8, 10
             and 11's tensor-core instances
  3 kernel   each kernel against its plain PyTorch version on the card,
             at the CHIPEQ geometry, a ragged one and the main path's:
             max |kernel - plain| / max |plain| <= 0.02; timed there,
             beside the replaced kernels' times from PERF.md. B1 is held
             on its output, its conv part and each of its four
             intermediates, and each of B1_FAULTS planted in turn in its
             tensor-core launches must miss by 3x the bar; B2 in both
             layouts of z1, and at a multi-image ragged geometry with
             each of B2_FAULTS planted missing by 3x the bar
  4 path     the 2K frame through the kernels, launches counted (B1 and
             B2 all on the tensor cores, as B1, B2, 6 and 13 on every
             counted system path below: the "<path>/tc_bodies" lines); shape and
             finiteness; trunk features and the unclipped frame against
             the same path through the plain model within 0.03
  5 times    frame MP/s, trunk and tail ms
Then the hybrid RRDBNet -> HAT x4 deploy path (stage 1 RRDBNet x2, 23
RRDBs, 1 channel; stage 2 HATLite, embed 96, 4 groups of 6 HABs, 6
heads, window 8), 128x128 -> 512x512, batch 1, bf16, random weights from
a second seed:
  6 hybrid-kernels  kernels 7 (fused_cab_convs), 8 (fused_hab_block) and
             9 (flash_oca_gathered) against their plain versions at a
             CHIPEQ-sized geometry, a ragged one and the main path's,
             within 0.02 (CAB) and 0.03 (HAB, OCA) of max |plain|, timed
             at the latter (kernel 9 with its exponentials' count and
             floor beside its bound, and its replaced kernel's time from
             PERF.md, not re-run); HAB also on out - x - cab, CAB also on
             its GELU hidden map, kernel 7 one call of one launch of its
             tensor-core body (kernel 7 timed beside its first form's
             three launches, live, and the cuDNN composition
             SRTPU_XLA_CAB runs); at the first geometry each check must
             also fail on each of six faults planted in the kernels'
             inputs, kernel 7 miss by 3x the bar with each of its three
             faults planted in its body (LN(0) outside the image, the
             hidden map not zeroed there, a 1-pixel halo) and kernel 8
             with each of its two (a q/k/v GEMM slab skipped, LN2
             skipped)
  6b cab-widths     kernel 7 at C 120 (hidden 40), C 128 with c_real 96
             and a ragged [2,100,70,96] the same way, each timed
  7 hybrid-path     one frame through fused_hybrid_model, launches counted
             (exact); shape and finiteness; stage 1, stage 2 and the
             frame after it (both fed the kernel path's own stage-2
             input) against the plain HybridSR on the same bf16 weights
             within 0.03; both paths' distances from the plain model in
             f32, and the whole frame's, printed
  8 hybrid-times    ms/frame and MP/s (input MP), stage 1 and 2 ms, the
             plain model's frame, B1 at stage 1's shape, the device time
             of a frame (torch.profiler) and its busy share, peak memory
Then hybrid_astro training (the preset at full width: RRDBNet x2, 23
RRDBs; HATLite x2, embed 96, 4 groups of 6; remat; bf16 over f32
masters; batch 4, 128x128 -> 512x512; star L1; AdamW, clip 1, cosine),
random weights from the Trainer's seed:
  9 train-kernels   kernel 13, autograd through the training path's op
             fused_dense_block_train, against autograd through B1's plain
             version in f32 (its lrelu slopes pinned to the kernel's
             forward), at a CHIPEQ-sized geometry, a ragged one and the
             main shape: value and dx within 0.02, each dW and db within
             0.03, dres exactly, every call on the tensor cores, two
             calls giving the same bits of dW and db; kernel 14, autograd
             through star_weighted_l1_cuda, value and gradient within 1e-4
             at [4,512,512,1] and a ragged n; each check must fail on
             each fault planted in it (four in kernel 13's launch
             helpers, two in kernel 14's inputs); kernel 14's forward
             one CUDA kernel a call (profiled), two calls giving the same
             value bits; both timed at the main shapes, 13 beside its
             direct launches (the parent kernel's) and split by launch on
             both routes ("k13_split"), 14 beside its first form's time
  9b f32-routes     (C4) B1 and kernel 13 with f32 activations on the conv
             engine's direct body at [4,128,128,64] against their plain
             f32 versions within 1e-4: B1's output, 13's dx, dW, db;
             every launch off the tensor cores; timed beside bf16
 10 train-path      the port's Trainer fits TRAIN_STEPS steps, evaluates
             once and writes a checkpoint, launches counted (exact per
             step: B1 621, kernel 13 69, kernel 14 2, the deploy kernels
             0); loss, grad norm and PSNR finite; one fixed batch through
             the kernels against the plain model in bf16 on the same f32
             masters: loss within 0.01, grad norm within 0.03, and per-leaf
             gradients (conv_first, the first, middle and last RRDB,
             conv_body, stage 2's conv_first) within 0.03, each beside
             both paths' distance from f32
 10b fp32-step      (C4) a Trainer with precision "fp32" and fused_trunk
             takes one fit step (B1 621 and kernel 13 69 launches, all on
             the direct f32 route); its loss and every gradient against
             the plain f32 step within 1e-3 of max |plain|
 11 train-times     ms/step, samples/s and input MP/s over TIME_STEPS steps
             on one batch on the card, stage 1 and stage 2 forward +
             backward, the plain step, device time by kernel
             (torch.profiler) and its busy share, peak memory
Then the public upscale API over the hybrid as bench_hybrid declares it
(HATLite attn_f32=False, flash_attn=True: every window attention and
OCAB on kernel 10), with no output resize, random weights from a fourth
seed, bf16:
 12 attn-kernel     kernel 10 (flash_window_attention) against its plain
             version at the path's shapes (41,472 windows, C 96, 6
             heads): self unshifted, self shifted (region ids), cross (m
             144, rel-pos-like bias), in f32 within 1e-4 (5e-4 cross) and
             bf16 within 0.02 of max |plain|, the logit spread printed;
             four planted faults (mask dropped, bias dropped, scale
             C^-1/2, ids of window b // nW) each caught; gradients through
             the autograd op equal plain autograd's within 1e-6; kernel
             (bf16: the tensor cores, every launch counted there), plain
             and scaled_dot_product_attention ms with the bound, its
             first form's (K10_OLD_MS) printed
 12b map-form       kernel 10's map form (flash_map_attention, the HAB's
             self-attention read from the qkv map [8,576,576,288]) at
             shift 0 and 4 against roll, partition, plain attention,
             merge, roll back: bf16 within 0.02, f32 within 1e-4; three
             faults planted in it (the mask dropped, the shifted address
             clamped, the last key tile skipped) each missing by 3x the
             bar; timed beside SDPA (the first form's chain printed)
 12c widths         kernel 10 in bf16 at the other widths (head dim 16 at
             1-5 and 7 heads, 20 at 1-5) on windows at every (n, m) and
             on the map at ws 8 and 16 within 0.02, every launch on the
             tensor cores; HATLite at (64, 4) and (60, 3) under flash_attn
             within 0.03 of plain attention (kernel 10 x3)
 13 upscale-path    a 1024^2 frame through api.upscale(on_device=True,
             tile 256, halo 16, batch 8): 4096^2, finite, in [0, 1];
             kernel-10 launches exactly 56 (2 batches x (24 HAB + 4
             OCAB)), all on the tensor cores, 48 of them the map form,
             and every other kernel 0; within 0.03 of the same call on
             plain attention with f32 logits (timed once); the host
             tiler within 1e-3 of the on-device one; hann printed; frame
             s, MP/s, peak memory; the frame's device
             split by kernel and by group, beside the split with kernel
             10's first form (K10_OLD_FRAME, printed)
 14 no-gather       bench_hybrid's frame through fused_hybrid_model with
             SRTPU_GATHER_OCA=0 (kernel 10 x 4, kernel 9 x 0, B1 and
             kernels 7-8 as in phase 7), stage 2 and after within 0.03
             of the plain HybridSR; an odd-overlap HATLite (ows 11)
             through make_fused_hat within 0.03 of the plain one
 15 anchor          the committed checkpoint (assets/quality/port)
             through fused_rrdb_model (B1-B3) in bf16 on bench.py's
             quality data: PSNR within 0.05 dB of the reference's
             25.595, bicubic PSNR within 0.002 dB of 23.599; SSIM printed
Then phases 16-21: kernels 4-6 against their plain versions with two
planted faults each, kernel 6's tensor-core launch also with its stage
barrier skipped (on NaN-filled scratch), kernel 6 timed beside three B1
calls and its direct chain (16), the 2K frame under the trunk levers fold_ends
and chain_rrdb (17, run right after phase 5), kernels 8-10 at window 16,
head dim 20 and ows 10 (18; kernel 9 also at ws 16 on three images of
48 x 80, three faults planted in it and two in its inputs each missing
by 3x the bar), the hybrid_astro_h200-class frame (19), an
ows 10 HATLite (20), api.upscale over both prebound fused models on both
tilers (21). Then the fused HAT's deploy levers, random weights from a
sixth seed:
 22 strip-kernel    kernel 11 (strip_hab_block) against its plain version
             within 0.03 on [1,256,256,C] maps (window 8 at C 96, window
             16 at C 96 and 120; shift 0 and ws/2), also on out - x - cab;
             three faults planted in the kernel (coordinates clamped for
             the wrap, SE not applied, region mask off) must each miss by
             3x the bar; timed beside the windowed route of kernel 8 with
             its rolls, partitions and SE passes, and the plain version
 23 pair-kernel     kernel 12 (fused_cab_convs_pair, one launch of kernel
             7's tensor-core body, LN divided by C) within 0.02 at
             [1,256,256,96], [1,256,256,120] and a ragged map, one cab_tc
             launch a call on its own count, kernel 7's counts unmoved;
             two planted faults (the hidden map not zeroed outside the
             image, a pair's pixels swapped) at 3x the bar; timed at C 96
             and 120 beside kernel 7 and the first form's times
 24 padded-kernels  kernels 7, 8, 9 at C 128 with c_real 96 and 8 heads
             within 0.02 / 0.03 of their plain versions, the pad lanes of
             each output exactly zero; timed
 25 lever-frames    bench_hybrid's frame under SRTPU_STRIP_HAB,
             SRTPU_LANE_PAD and SRTPU_XLA_CAB, one at a time: exact
             launches (strip: kernel 11 x24, kernel 8 x0; lane pad:
             kernels 8 x24 and 9 x4, each at C 128; xla cab: kernel 7 x0),
             the frame within 0.03 of the plain HybridSR end to end and
             after stage 2 on the kernel path's stage-2 input (phase 7's
             rule), stage 2's distances from plain and from the default
             path printed; frame ms, stage-2 host and device ms, between
             two default frames
 26 h200-levers     the h200-class frame under the strip lever (kernel 11
             x36 at window 16, C 120) and under lane pad, which does not
             apply at head dim 20: the frame runs unpadded at C 120
Then the serving path of the system's default model family through
kernel 15 (conv3x3_depth_to_space, the sub-pixel heads), random weights
from a seventh seed, bf16:
 27 subpixel-kernel kernel 15 against its plain version (F.conv2d and
             F.pixel_shuffle; f32 with TF32 off) at test_pallas.py's
             geometries, a ragged one (r 3) and the three path shapes
             (EDSR stages 1 and 2, ESPCN's head), in both bodies of the
             conv engine (bf16 channels-last: tensor cores; f32 and NCHW:
             direct; the direct body also in bf16 at the path shapes):
             bf16 within 0.02 and f32 within 1e-4 of max |plain|; three
             faults planted in the kernel ((i, j) swapped in the store,
             the border clamped, the bias dropped) must each miss by 3x
             the bar in each body; timed at the path shapes beside the
             direct body, the plain version and F.conv2d alone (cuDNN);
             registers and spills of each body (the tensor-core body
             must not spill)
 28 edsr-upscale    EDSR-baseline x4 (16 resblocks x 64 features),
             conv_last fitted, a 1024^2 RGB frame through
             api.upscale(on_device=True, tile 256, halo 16, batch 8):
             kernel 15 exactly 4 launches, all on the tensor cores, and
             every other kernel 0; 4096^2,
             finite, in [0, 1]; within 0.03 of the same call with the
             plain op; the host tiler within 1e-3; frame s, MP/s, the
             plain frame, peak memory, device time by kernel
 29 espcn-upscale   the same for ESPCN x4 on a 1024^2 grayscale frame
             (kernel 15 x2)
 30 eval-folder     phase 28's EDSR saved as a checkpoint directory with
             its model_config.json, loaded back as cmd_eval_folder does
             (load_params_for_inference, build_from_config, total_scale)
             and scored by evaluate_folder through api.upscale on 4
             synthetic HR PNGs (two ragged): PSNR within 0.05 dB and SSIM
             within 0.002 of the same evaluation with the plain op;
             kernel 15 on the tensor cores
Then single-device training at the reference's defaults, random weights
from an eighth seed:
 31 seg-kernels     B1 and kernel 13 with `seg` (batch-packed rows, one
             zero spacer row per image) at esrgan_x4_tiled's packed
             geometry [1, 8*49, 48, 64], the RRDB residual folded, against
             their plain seg forms: value and dx within 0.02, dW and db
             within 0.03, dres exactly; the spacer rows of the value and
             of dx exactly 0; three planted faults (a spacer every H rows,
             no row masked, spacer rows not zeroed at the store) each
             missing by 3x the bar; timed packed, per image [8,48,48,64]
             and plain, with the bound
 32 packed-train    esrgan_x4_tiled (23 RRDBs x 64, growth 32, batch 8, hr
             192, bicubic, bf16) for 3 steps with fused_trunk=True: B1
             and kernel 13 launches exact, every one with seg; once more
             with fused_trunk=None under SRTPU_PACKED_TRAIN (and not packed
             without it); one step against the plain step in f32 (loss
             0.01, gradients 0.03; the plain bf16 step's distances
             printed); ms/step packed, per image and plain, a profiled
             step's busy share
 33 bicubic-presets edsr_baseline_x4 at full width (16 x 64, hr 192,
             batch 16) for 3 steps, eval and a preview PNG every step,
             async checkpoints, kernel 15's launches exact and on the
             tensor cores (ESPCN's too); the best step
             finalized with params_probe and reloaded by
             load_params_for_inference, equal on a patch to the module
             restored by restore_best; srcnn_x2, espcn_x4, fsrcnn_x4 for 2
             steps each; ms/step each; blur_bicubic and bsr_light LR made
             on the card against the CPU from fixed draws
 34 manifest-train  8 synthetic 128^2 / 512^2 16-bit TIFF pairs and a
             train/val/test manifest (under outputs/chip_smoke_manifest/);
             hybrid_astro at full width trains 2 steps from it (B1,
             kernels 13 and 14, exact) with a preview due; the g++-built
             native decoder must have served batches; run_test writes its
             TIFFs, labelled strips and metrics.txt
Then the reference's last Pallas kernels outside benchmarks/, which no
path of the system runs: each phase drives the kernel's own entry point
once at full shape with every count set to 0 just before (that kernel
exactly, every other none), random values from a ninth seed. Every
counted run of a system path above also counts kernels 12 and 16-19 and
fails unless each is 0; the kernels line gives their sums over those
runs (launches_system_paths; kernel 12's launches too) and how many runs
were counted:
 35 dense-valid     kernel 16 (fused_dense_block_valid, pad once, five
             VALID convs) at B1's timed tile [24,376,256,64] on B1's check
             weights: bf16 on the tensor-core body (5 launches, 0 direct)
             within 0.02 of the plain form, over the whole image and the
             5-px border; the interior within 0.02 of B1; two planted
             faults (SAME zeroing, caught on the border; the 0.2 scale
             dropped) by 3x the bar; f32 within 1e-4 and a bf16 shape off
             the route rule (c 36, g 12) within 0.02 on the direct body;
             timed beside B1, the plain form, the weight packing and the
             direct body in bf16
 36 blur-kernel     kernel 17 (anti_checkerboard_kernel) at [4,256,256,1]
             balanced, [4,512,512,1] balanced and light, [8,128,128,64]
             strong: f32 within 1e-5, bf16 within 0.01; two planted
             faults (row-sum normalizer, corner tap dropped) by 3x the f32
             bar; timed beside the plain blur and the depthwise F.conv2d
 37 pack-conv       kernel 18 (pack_conv3x3, p 2) at the dense block's
             five convs at the same tile, in both bodies (bf16: tensor
             cores, and direct through its helper; f32: direct): bf16
             within 0.02, f32 within 1e-4, pad packs exactly 0; a chained
             lrelu pair; the backward against autograd of the plain form;
             two planted faults (pad packs kept, the cross-pack left tap
             dropped) by 3x the bar in each body; timed beside the direct
             body, the plain form and F.conv2d
 38 passthrough     kernel 19 (make_pt) at [24,376,272,64] and
             [24,376,136,128], rb 94: exact in bf16 and f32; the last band
             left unwritten must be caught, band 95 alone wrong; timed
             beside x.clone(), copy_ and the replaced kernel's time from
             PERF.md; dma_probe's GB/s beside the nominal 3,350
Then B1's, B2's, 6's and 13's launches by body over every counted
system path,
the kernels line (B1-19 and the seg forms of B1 and kernel 13, launches
from each path's run), the card's nvidia-smi line and, last,
{"ok": true, "device": {...}}. Every phase line carries t_s, the seconds
since the script started.

Usage: python3 chip_smoke.py   (one CUDA GPU; nvcc in $CUDA_HOME/bin,
/usr/local/cuda/bin or on PATH)
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
H, W = 1080, 1920
TILE, HALO = (360, 240), 8
TAIL_BATCH = 8            # 3 tail chunks over the 24 tiles
TOL_KERNEL = 0.02         # CHIPEQ's bar for fused_dense_block / phase_tail
TOL_PATH = 0.03           # 69 chained bf16 blocks round more than one call
PEAK_FLOPS = 989e12       # H100 SXM dense bf16
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SRC = "superresolution_tpu_torch/ops/csrc/sr_kernels.cu"
DENSE_SRC = "superresolution_tpu_torch/ops/csrc/dense_kernels.cu"   # B1
TAIL_SRC = "superresolution_tpu_torch/ops/csrc/tail_kernels.cu"     # B2
HAT_SRC = "superresolution_tpu_torch/ops/csrc/hat_kernels.cu"
CAB_SRC = "superresolution_tpu_torch/ops/csrc/cab_kernels.cu"      # 7
TOL_HAB = 0.03            # CHIPEQ's bar for fused_hat_* and flash_oca
HYBRID_IN = 128           # 128x128 -> stage 1 x2 -> stage 2 x2 -> 512x512
# multiply-accumulates per pixel of each op (c=64, g=32)
B1_MACS = 9 * sum((64 + j * 32) * (32 if j < 4 else 64) for j in range(5))
RECOMPUTE_MACS = 9 * sum((64 + j * 32) * 32 for j in range(4))  # B1's convs 1-4
B2_MACS = 4 * 9 * 64 * 256 + 16 * 9 * 64 * 64     # per LR pixel
B3_MACS = 9 * 64 * 3                              # per HR pixel
# hybrid stage 2 (C 96, 6 heads of 16, 8x8 windows, MLP 192, OCAB 12x12)
CAB_MACS = 2 * 9 * 96 * 32                        # per pixel
HAB_MACS = 96 * 288 + 96 * 96 + 2 * 96 * 192 + 2 * 64 * 96  # per token
OCA_MACS = 2 * 144 * 96                           # per query token
TRAIN_SRC = "superresolution_tpu_torch/ops/csrc/train_kernels.cu"
TRAIN_TC_SRC = "superresolution_tpu_torch/ops/csrc/train_tc_kernels.cu"
TOL_DW = 0.03             # CHIPEQ's bar for dense_train_dw*
TOL_STAR = 1e-4           # CHIPEQ's bar for star_l1_*
TRAIN_BATCH, TRAIN_LR, TRAIN_SCALE = 4, 128, 4   # hybrid_astro: 128 -> 512
TRAIN_STEPS = 2           # steps of the Trainer's fit in phase 10
TRAIN_DIR = "outputs/chip_smoke_train"   # .gitignore lists outputs/
TOL_STEP_LOSS = 0.01      # kernel step vs plain bf16 step
TOL_STEP_GNORM = 0.03
TOL_LEAF = 0.03           # per-leaf gradients, of max |plain|
TIME_STEPS = 2            # steps timed after one warm-up
ATTN_SRC = "superresolution_tpu_torch/ops/csrc/attn_kernels.cu"
OCA_SRC = "superresolution_tpu_torch/ops/csrc/oca_kernels.cu"
FLASH_SRC = "superresolution_tpu_torch/ops/csrc/flash_tc.cuh"  # 9's, 10's
ATTN_TC_SRC = "superresolution_tpu_torch/ops/csrc/attn_tc_kernels.cu"
ATTN_WIDTH_SRCS = tuple(f"superresolution_tpu_torch/ops/csrc/"
                        f"attn_tc_widths{hd}.cu" for hd in (16, 20))
TOL_F32 = 1e-4            # B1 and kernel 13 in f32 (C4), as 15 and 18
TOL_FP32_STEP = 1e-3      # an fp32 fused step against the plain f32 one
# the special-function units' exponentials a second: 132 SMs x 16 a clock
# x 1.98 GHz (H100 SXM), a floor under kernel 9 beside its bound
EXP_RATE = 132 * 16 * 1.98e9
# The kernel 9 replaced (attn_kernels.cu attn_kernel<..., true>, one block
# a window and head, f32 FMA on the CUDA cores) at each timed geometry, as
# PERF.md's kernel table keeps it (row 9). Printed as a reference, not
# re-run.
# kernels 8 and 11's first form (hat_kernels.cu hab_kernel, every product
# in f32 FMA on the CUDA cores), timed beside the tensor-core body in the
# same run before it was taken out (PERF.md rows 8 and 11); c_real's in a
# run whose kernel-8 step passed and which then failed in phase 6 on an
# error of the script's (PERF.md row 8)
HAB_OLD = "hat_kernels.cu hab_kernel's first form, CUDA cores"
# kernel 12's first form (hat_kernels.cu cab_pair_kernel<C>, two pixels a
# thread, f32 FMA on the CUDA cores) at phase 23's timed maps, timed on
# the tree before it was taken out (PERF.md row 12)
K12_OLD = "hat_kernels.cu cab_pair_kernel<C>'s first form, CUDA cores"
K12_OLD_MS = {"c96": 0.5227, "c120": 1.0218}
HAB_OLD_MS = {"main": 0.6465, "hab_c96_n256": 1.2444, "hab_c120_n256": 2.2855,
              "hab_c128_nh8_n64": 0.929, "strip_c96_ws8": 0.6682}
OCA_OLD = "attn_kernels.cu attn_kernel<bf16, hd, n, m, true>, CUDA cores"
# kernel 10's first form (attn_kernels.cu attn_kernel<bf16, hd, n, m>, one
# block a window and head, f32 FMA on the CUDA cores, the raw bias through
# L2) and, for the map form, its chain of roll, window_partition, that
# kernel, window_merge and roll back: timed beside the tensor-core body in
# the same run before its bf16 instances were taken out (PERF.md row 10);
# the upscale frame with the HAB on windows around it
K10_OLD = "attn_kernels.cu attn_kernel<bf16, hd, n, m>'s first form, CUDA cores"
OCA_OLD_MS = {"main": 0.374, "oca_c96_ws8_ows10": 0.287,
              "oca_c96_ws16_ows24": 1.446, "oca_c120_ws16_ows24": 1.674,
              "oca_c128_nh8_ws8_ows12": 0.483}
K10_OLD_MS = {"unshifted": 7.0974, "shifted": 7.1824, "cross": 12.5773,
              "map": 19.056, "hd16_n64_m100": 0.2891,
              "hd16_n256_m256": 0.741, "hd16_n256_m576": 1.463,
              "hd20_n64_m64": 0.2492, "hd20_n64_m100": 0.3415,
              "hd20_n64_m121": 0.3969, "hd20_n64_m144": 0.4333,
              "hd20_n256_m256": 0.8107, "hd20_n256_m576": 1.6246}
K10_OLD_FRAME = {"frame_s": 2.6697, "device_ms": 2616.8,
                 "by_group_ms": {"strided elementwise": 818.5,
                                 "copies, rolls, concatenations": 483.4,
                                 "kernel 10": 442.5, "LayerNorm": 341.5,
                                 "convs": 237.1, "linears (GEMM)": 137.1,
                                 "contiguous elementwise": 113.1,
                                 "other": 43.7}}
TOL_ATTN = 1e-4           # CHIPEQ's bar for flash_window_attention (f32)
TOL_ATTN_CROSS = 5e-4     # CHIPEQ's bar for flash_oca_stacked (f32, m 144)
TOL_ATTN_BF16 = 0.02      # bf16 probabilities and output
TOL_ATTN_GRAD = 1e-6      # the op's backward is plain autograd
FRAME = 1024              # phases 13, 28, 29: a 1024^2 frame, x4 -> 4096^2
UP_TILE, UP_HALO, UP_BATCH = 256, 16, 8   # 16 tiles in 2 batches of 8
TOL_TILERS = 1e-3         # host tiler vs on-device tiler (expected 0)
ANCHOR_DIR = "assets/quality/port"
ANCHOR_PSNR = 25.595      # the reference's figure (BENCH_r05.json)
ANCHOR_BICUBIC = 23.599   # the reference's bicubic figure
TOL_ANCHOR = 0.05         # VERDICT.md's bar for the anchor
TOL_ANCHOR_BICUBIC = 0.002


T0 = time.perf_counter()


def emit(obj) -> None:
    """Prints obj as one JSON line; a phase line also gets t_s, the
    seconds since the script started, so phases' times can be read off
    the log."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, in f32."""
    g, r = got.float(), ref.float()
    return float((g - r).abs().max()) / max(float(r.abs().max()), 1e-6)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor,
            tol: float, **extra) -> dict:
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite values")
    d = float((g - r).abs().max())
    rel = d / max(float(r.abs().max()), 1e-6)
    res = {"check": name, "max_abs_err": d, "max_rel_err": rel, "tol": tol,
           **extra}
    emit(res)
    if rel > tol:
        raise AssertionError(f"{name}: relative error {rel} > {tol}")
    return res


def time_ms(fn, iters: int) -> float:
    """Mean device ms of fn over `iters` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """Mean device ms of fn over `iters` calls queued behind a spin of the
    card (dma_probe.copy_ms's clock): the card's time alone, where
    time_ms's span also holds any host time to issue a call that exceeds
    the card's."""
    from superresolution_tpu_torch.utils.dma_probe import SPIN_CYCLES

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def issue_ms(fn, iters: int) -> float:
    """Host ms to issue one call of fn, over `iters` calls queued behind
    a spin of the card (so that no call waits for it)."""
    from superresolution_tpu_torch.utils.dma_probe import SPIN_CYCLES

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


def card_state() -> str:
    """The card's clocks, temperature, power draw and the reasons its
    clocks are held down, as nvidia-smi reads them now."""
    q = ("clocks.sm,clocks.mem,temperature.gpu,power.draw,"
         "clocks_throttle_reasons.active")
    r = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={q}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return (r.stdout or r.stderr).strip()


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def dense_check_weights(gen: torch.Generator, c: int = 64, g: int = 32,
                        bias_scale: float = 0.1):
    """B1's weights for its check: MSRA x 2 kernels and N(0, bias_scale^2)
    biases. At the model's MSRA x 0.1 the convs make up ~2% of B1's output
    and the identity term x the rest, so a check of the output could not
    see them; at x 2 they make up most of it (conv_share in the check
    line). Phase 3 takes biases of 0.5, at which a dropped bias of conv 3
    or 5 misses the bar by 3x (at 0.1 by 2.5x and 1.6x)."""
    from superresolution_tpu_torch.ops import dense_trunk as dt

    ks, bs = [], []
    for j in range(5):
        cin, cout = c + j * g, g if j < 4 else c
        ks.append(torch.randn(3, 3, cin, cout, generator=gen)
                  * 2 * (2 / (9 * cin)) ** 0.5)
        bs.append(torch.randn(cout, generator=gen) * bias_scale)
    return dt.dense_weights(ks, bs, device="cuda")


def dense_block_pairs(ws, x: torch.Tensor, res: torch.Tensor) -> dict:
    """B1 against its plain version in f32 on the same (upcast) inputs,
    without and with `res`: {check: (got, ref, bar)} for three kinds of
    check, each within TOL_KERNEL of the plain one's max:
      - the output ("out");
      - its conv part: (out - x) / 0.2, or (out - res - 0.2 x) / 0.04;
      - each of y_1..y_4 in the workspace; the kernel's starts as NaN, so
        a slice that no launch writes fails.
    The plain version runs in f32 because the conv part's 1/0.04 would
    magnify its own bf16 roundings to about half the bar."""
    from superresolution_tpu_torch.ops import dense_trunk as dt

    b, h, w, _ = x.shape
    g = ws[0][0].shape[-1]
    pairs = {}
    for suffix, r in (("", None), ("+residual", res)):
        wk = torch.full((b, h, w, 4 * g), float("nan"), dtype=x.dtype,
                        device=x.device)
        wp = torch.empty(wk.shape, dtype=torch.float32, device=x.device)
        before = dt.fused_dense_block.launches
        got = dt.fused_dense_block(x, ws, r, workspace=wk)
        if dt.fused_dense_block.launches != before + 5:
            raise AssertionError("fused_dense_block: launch count did not go "
                                 "up by 5")
        ref = dt.fused_dense_block_reference(
            x.float(), ws, None if r is None else r.float(), workspace=wp)
        pairs[f"out{suffix}"] = (got, ref, TOL_KERNEL)
        ident, k = ((x.float(), 0.2) if r is None
                    else (r.float() + 0.2 * x.float(), 0.04))
        pairs[f"conv_part{suffix}"] = ((got.float() - ident) / k,
                                       (ref - ident) / k, TOL_KERNEL)
        for j in range(4):
            sl = slice(j * g, (j + 1) * g)
            pairs[f"y{j + 1}{suffix}"] = (wk[..., sl], wp[..., sl],
                                          TOL_KERNEL)
    return pairs


def check_dense_block(ws, x: torch.Tensor, res: torch.Tensor,
                      tag: str) -> dict:
    """dense_block_pairs, each within its bar (conv_share, the conv part's
    share of the output's max, printed beside it); returns the worse of
    the two output checks."""
    pairs = dense_block_pairs(ws, x, res)
    lines = {}
    for k, (got, ref, tol) in pairs.items():
        extra = {}
        if k.startswith("conv_part"):
            out_ref = pairs[k.replace("conv_part", "out")][1]
            scale = 0.2 if k == "conv_part" else 0.04
            extra["conv_share"] = float(ref.abs().max() * scale
                                        / out_ref.abs().max())
        lines[k] = compare(f"fused_dense_block/{tag}/{k}", got, ref, tol,
                           **extra)
    return max((lines["out"], lines["out+residual"]),
               key=lambda e: e["max_rel_err"])


# Faults planted in one of B1's five launches (0-based) by changing that
# launch's arguments to _build.dense_conv (the tensor-core route); the
# check must miss each by TOL_PLANT_FACTOR times its bar or more.
B1_FAULTS = {
    "conv1_no_lrelu": (0, lambda a: a.update(lrelu=False)),
    "conv2_wrong_out_off": (1, lambda a: a.update(
        out_off=2 * a["w"].shape[-1])),
    "conv3_no_bias": (2, lambda a: a.update(bias=None)),
    "conv5_no_bias": (4, lambda a: a.update(bias=None)),
    "conv5_skips_y4": (4, lambda a: a.update(
        cin1=a["cin1"] - 32, w=a["w"][:, :, :-32].contiguous())),
    "conv5_zero": (4, lambda a: a.update(w=torch.zeros_like(a["w"]),
                                         bias=None)),
}


def check_dense_block_faults(ws, x: torch.Tensor, res: torch.Tensor) -> None:
    """B1's checks with each of B1_FAULTS planted in its tensor-core
    launches; raise unless each misses by 3x the bar or more."""
    from superresolution_tpu_torch.ops import _build

    real = _build.dense_conv
    names = ("x", "ws", "cin1", "w", "bias", "out", "out_off")
    for fault, (launch, change) in B1_FAULTS.items():
        count = [0]

        def planted(*args, **kw):
            a = dict(zip(names, args), **kw)
            if count[0] % 5 == launch:
                change(a)
            count[0] += 1
            real(**a)

        _build.dense_conv = planted
        try:
            pairs = dense_block_pairs(ws, x, res)
        finally:
            _build.dense_conv = real
        if count[0] != 10:
            raise AssertionError(f"B1 fault {fault}: {count[0]} tensor-core "
                                 "launches, expected 10")
        judge_pairs("fused_dense_block", pairs, fault)


def check_kernels(model, gen: torch.Generator, n_tiles: int) -> dict:
    """Phase 3: B1, B2, B3 against their plain versions, at the CHIPEQ
    geometry, at a ragged one and at the main path's shapes; timed at the
    latter."""
    from superresolution_tpu_torch.infer.common import hwio
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import phase_tail as pt

    dev, bf = torch.device("cuda"), torch.bfloat16
    sd = model.state_dict()
    ws = dense_check_weights(gen, bias_scale=0.5)
    tail_w = [hwio(sd["conv_up2.weight"]).to(bf), sd["conv_up2.bias"].float(),
              hwio(sd["conv_hr.weight"]).to(bf), sd["conv_hr.bias"].float()]
    last_w = [hwio(sd["conv_last.weight"]).to(bf),
              sd["conv_last.bias"].float()]

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, bf)

    th, tw = TILE[0] + 2 * HALO, TILE[1] + 2 * HALO
    out = {}
    # "ragged" leaves partial thread-block tiles at every image edge
    for geom, (b, h, w) in (("chipeq", (2, 48, 64)), ("ragged", (1, 37, 45)),
                            ("main", (n_tiles, th, tw))):
        # res small, so the convs make up most of B1's residual output too
        x, res = randn(b, h, w, 64, scale=0.2), randn(b, h, w, 64, scale=0.05)
        e1 = check_dense_block(ws, x, res, geom)
        if geom == "chipeq":
            check_dense_block_faults(ws, x, res)
        bt = min(b, TAIL_BATCH)
        z1 = F.leaky_relu(randn(bt, h, w, 256, scale=0.3), 0.2)
        before = pt.up2_hr.launches
        y_ref = pt.up2_hr_reference(z1, *tail_w)
        compare(f"up2_hr/{geom}", pt.up2_hr(z1, *tail_w), y_ref, TOL_KERNEL)
        if pt.up2_hr.launches != before + 2:
            raise AssertionError("up2_hr did not count 2 launches")
        # the path's form: z1 phase-major, conv_up2's operands made once
        z1p, up2p = pt.to_phase_major(z1), pt.phase_major_up2(*tail_w[:2])
        e2 = compare(f"up2_hr/{geom}/phase", pt.up2_hr(
            z1p, *tail_w, layout="phase", up2_phase=up2p), y_ref, TOL_KERNEL)
        before = pt.conv_last_phase.launches
        e3 = compare(f"conv_last_phase/{geom}",
                     pt.conv_last_phase(y_ref, *last_w),
                     pt.conv_last_phase_reference(y_ref, *last_w),
                     TOL_KERNEL)
        if pt.conv_last_phase.launches <= before:
            raise AssertionError("conv_last_phase did not count launches")
        if geom == "chipeq":
            check_conv_last_faults(gen)
            check_up2hr_faults(gen)
            check_direct_routes(gen)
        if geom != "main":
            continue

        px = b * h * w
        lr_px, hr_px = bt * h * w, bt * h * w * 16
        lw_oihw = last_w[0].permute(3, 2, 0, 1).contiguous()
        y_nchw = y_ref.permute(0, 3, 1, 2)
        rows = [
            ("fused_dense_block", DENSE_SRC, "superresolution_tpu/ops/"
             "pallas_dense_trunk.py:237",
             e1, lambda: dt.fused_dense_block(x, ws, res),
             lambda: dt.fused_dense_block_reference(x, ws, res), None, 10,
             2 * px * B1_MACS, 3 * px * 64 * 2 + 2 * B1_MACS + 4 * 192,
             [b, h, w, 64]),
            ("up2_hr", TAIL_SRC,
             "superresolution_tpu/ops/pallas_phase_tail.py:319", e2,
             lambda: pt.up2_hr(z1p, *tail_w, layout="phase",
                               up2_phase=up2p),
             lambda: pt.up2_hr_reference(z1, *tail_w), None, 5,
             2 * lr_px * B2_MACS,
             lr_px * 256 * 2 + hr_px * 64 * 2 + 2 * 9 * 64 * 320 + 4 * 320,
             [bt, h, w, 256]),
            ("conv_last_phase", STREAM_SRC, "superresolution_tpu/ops/"
             "pallas_phase_tail.py:340", e3,
             lambda: pt.conv_last_phase(y_ref, *last_w),
             lambda: pt.conv_last_phase_reference(y_ref, *last_w),
             lambda: F.conv2d(y_nchw, lw_oihw, last_w[1].to(bf), padding=1),
             10, 2 * hr_px * B3_MACS, hr_px * (64 + 3) * 2 + 2 * 9 * 64 * 3,
             [bt, 4 * h, 4 * w, 64]),
        ]
        for name, src, tpu, err, kern, plain, lib, iters, flops, nbytes, \
                shape in rows:
            b_ms, b_by = bound(flops, nbytes)
            out[name] = {
                "name": name, "route": "cuda", "source": src,
                "replaces": tpu, "shape": shape,
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"], "tol": TOL_KERNEL,
                "ms": time_ms(kern, iters), "plain_ms": time_ms(plain, iters),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if lib is None else time_ms(lib, iters)}
            if name == "conv_last_phase":
                out[name].update(
                    sources=[STREAM_SRC, ENGINE_SRC],
                    ptxas=STENCIL_PTXAS.get("conv_last_kernel"))
            else:
                policy = ("DenseConv" if name == "fused_dense_block"
                          else "PhaseUp")
                out[name].update(sources=[src, ENGINE_SRC],
                                 ptxas=PTXAS.get(policy))
            emit({"phase": "kernel_time", **out[name]})
            kernel, ms, row = OLD_KERNELS[name]
            old_kernel(name, kernel, shape, ms, row)
    return out


# The kernels B1-B3, 6 and 13 replaced, at the main path's shapes, as
# PERF.md's kernel table keeps them (rows B1-B3, 6, 13): printed as
# references, not re-run (6's and 13's also run live beside them, on the
# direct route, as parent_kernel_ms).
OLD_KERNELS = {
    "fused_dense_block": ("sr_kernels.cu conv3x3_kernel x5, f32 FFMA",
                          40.22, "B1"),
    "up2_hr": ("sr_kernels.cu conv3x3_kernel<D2S> x2, f32 FFMA", 71.00,
               "B2"),
    "conv_last_phase": ("sr_kernels.cu conv_last_kernel, one thread per "
                        "output pixel", 6.89, "B3"),
    "fused_rrdb": ("sr_kernels.cu conv_chain_kernel, 15 stages of f32 FFMA "
                   "conv_tile", 162.64, "6"),
    "dense_block_backward": ("train_kernels.cu wgrad_kernel x5 + "
                             "sr_kernels.cu conv3x3_kernel x5, f32 FFMA",
                             3.562, "13"),
    "dense_block_backward_seg": ("the same with seg", 1.741, "13"),
    "fused_cab_convs": ("hat_kernels.cu layernorm_kernel + sr_kernels.cu "
                        "conv3x3_kernel x2, f32 FFMA", 0.425, "7"),
    "star_weighted_l1_cuda": ("train_kernels.cu star_l1_partial_kernel + "
                              "star_l1_reduce_kernel + star_l1_bwd_kernel, "
                              "one float a load", 0.0303, "14"),
}


# ---- B2 (tail_kernels.cu, PhaseUp): its own check ----------------------

B2_MULTI = (2, 37, 45, 64)   # b >= 2; ragged tiles at 2x and 4x
B2_FAULTS = ("PLANT_SWAP_PHASE", "PLANT_CLAMP_EDGE", "PLANT_BIAS_OFF")


def up2hr_check_weights(gen: torch.Generator, c: int):
    """B2's own check weights: MSRA kernels and N(0, 0.5^2) biases, so
    the bias and every tap show in the output."""
    bf = torch.bfloat16
    return [rand(gen, 3, 3, c, 4 * c, scale=(2 / (9 * c)) ** 0.5, dtype=bf),
            rand(gen, 4 * c, scale=0.5),
            rand(gen, 3, 3, c, c, scale=(2 / (9 * c)) ** 0.5, dtype=bf),
            rand(gen, c, scale=0.5)]


def check_up2hr_faults(gen: torch.Generator) -> None:
    """B2 at B2_MULTI on its own check weights, z1 = lrelu(N(0, 1)): in
    both z1 layouts within TOL_KERNEL of the plain version in f32 on the
    same values, and each of B2_FAULTS planted in the kernel missing by
    3x the bar."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import phase_tail as pt

    b, h, w, c = B2_MULTI
    z1 = F.leaky_relu(rand(gen, b, h, w, 4 * c), 0.2).to(torch.bfloat16)
    tw = up2hr_check_weights(gen, c)
    ref = pt.up2_hr_reference(z1.float(), tw[0].float(), tw[1],
                              tw[2].float(), tw[3])
    compare("up2_hr/multi", pt.up2_hr(z1, *tw), ref, TOL_KERNEL)
    z1p, up2p = pt.to_phase_major(z1), pt.phase_major_up2(*tw[:2])
    compare("up2_hr/multi/phase", pt.up2_hr(z1p, *tw, layout="phase",
                                            up2_phase=up2p), ref, TOL_KERNEL)
    for fault in B2_FAULTS:
        expect_margin(f"up2_hr:{fault}",
                      planted("up_conv", getattr(_build, fault),
                              lambda: pt.up2_hr(z1, *tw)),
                      ref, TOL_KERNEL)


def check_direct_routes(gen: torch.Generator) -> None:
    """The shapes the route rules send off the tensor cores (B1, kernels
    4-6 and 13 at C 24, g 12, kernels 4-6 on conv_chain_kernel; B2 at c
    12; kernel 7 at C 36, hidden 12, its three launches) on the direct
    bodies, within
    TOL_KERNEL of the plain versions in f32 on the same values (kernel
    13 through check_dense_backward's bars), each launch counted on
    direct_launches and none on tc_launches."""
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import phase_tail as pt

    ws = dense_check_weights(gen, c=24, g=12, bias_scale=0.5)
    x = rand(gen, 2, 37, 45, 24, scale=0.2, dtype=torch.bfloat16)
    r = rand(gen, 2, 37, 45, 24, scale=0.05, dtype=torch.bfloat16)
    ops = zero_counts()
    compare("fused_dense_block/direct_c24_g12", dt.fused_dense_block(x, ws, r),
            dt.fused_dense_block_reference(x.float(), ws, r.float()),
            TOL_KERNEL)
    c = 12
    z1 = F.leaky_relu(rand(gen, 2, 9, 11, 4 * c), 0.2).to(torch.bfloat16)
    tw = up2hr_check_weights(gen, c)
    compare("up2_hr/direct_c12", pt.up2_hr(z1, *tw), pt.up2_hr_reference(
        z1.float(), tw[0].float(), tw[1], tw[2].float(), tw[3]), TOL_KERNEL)
    ws3 = [ws] + [dense_check_weights(gen, c=24, g=12) for _ in range(2)]
    compare("fused_rrdb/direct_c24_g12", dt.fused_rrdb(x, *ws3),
            dt.fused_rrdb_reference(x.float(), *ws3), TOL_KERNEL)
    check_dense_backward(ws3[1], x, r, rand(gen, 2, 37, 45, 24,
                                            dtype=torch.bfloat16),
                         "direct_c24_g12")
    ends = (end_conv_weights(gen, 3, 24), end_conv_weights(gen, 24, 24))
    x_raw = rand(gen, 2, 37, 45, 3, scale=0.5, dtype=torch.bfloat16)
    head = rand(gen, 2, 37, 45, 24, scale=0.05, dtype=torch.bfloat16)
    got4 = dt.fused_dense_block_prologue(x_raw, ends[0], ws)
    ref4 = dt.fused_dense_block_prologue_reference(x_raw.float(), ends[0], ws)
    for i, part in enumerate(("", "/head")):
        compare(f"fused_dense_block_prologue/direct_c24_g12{part}", got4[i],
                ref4[i], TOL_KERNEL)
    compare("fused_dense_block_epilogue/direct_c24_g12",
            dt.fused_dense_block_epilogue(x, ws, r, ends[1], head),
            dt.fused_dense_block_epilogue_reference(
                x.float(), ws, r.float(), ends[1], head.float()), TOL_KERNEL)
    # kernel 7 at C 36, hidden 12: its three launches
    from superresolution_tpu_torch.ops import hab

    cg = torch.Generator().manual_seed(SEED + 13)  # gen's draws unmoved
    cw = hab.cab_mma_weights(cab_check_weights(cg, 36, 12))
    xc = rand(cg, 2, 37, 45, 36, dtype=torch.bfloat16)
    compare("fused_cab_convs/direct_c36", hab.fused_cab_convs(xc, cw),
            hab.fused_cab_convs_reference(xc.float(), cw), TOL_KERNEL)
    got = {k: [ops[k].tc_launches, ops[k].direct_launches]
           for k in (*BODY_OPS, *END_FOLD_BODIES)}
    emit({"check": "direct_routes/bodies", **got})
    if any(t or not d for t, d in got.values()):
        raise AssertionError(f"direct routes: bodies {got}")


# ---- B3 (stream_kernels.cu conv_last_kernel): its own check ----------

STREAM_SRC = "superresolution_tpu_torch/ops/csrc/stream_kernels.cu"
B3_MULTI = (3, 150, 260, 64)   # b >= 2; H, W not multiples of the band
                               # (64 rows) or the strip (126 columns)
B3_FAULTS = ("PLANT_ROW_CLAMP", "PLANT_WRONG_NEIGHBOUR", "PLANT_BIAS_DROPPED")


def check_conv_last_faults(gen: torch.Generator) -> None:
    """B3 at B3_MULTI on its own check weights (MSRA kernels, N(0, 1)
    biases, y N(0, 0.5^2), so the bias and every tap show in the output):
    within TOL_KERNEL of the plain version in f32 on the same values, and
    each of B3_FAULTS planted in the kernel missing by 3x the bar."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import phase_tail as pt

    bf = torch.bfloat16
    b, h, w, c = B3_MULTI
    y = rand(gen, b, h, w, c, scale=0.5, dtype=bf)
    k = rand(gen, 3, 3, c, 3, scale=(2 / (9 * c)) ** 0.5, dtype=bf)
    bias = rand(gen, 3)
    ref = pt.conv_last_phase_reference(y.float(), k.float(), bias)
    compare("conv_last_phase/multi", pt.conv_last_phase(y, k, bias), ref,
            TOL_KERNEL)
    for fault in B3_FAULTS:
        expect_margin(f"conv_last_phase:{fault}",
                      planted("conv_last", getattr(_build, fault),
                              lambda: pt.conv_last_phase(y, k, bias)),
                      ref, TOL_KERNEL)


def rand(gen: torch.Generator, *shape, scale: float = 1.0,
         shift: float = 0.0, dtype=torch.float32) -> torch.Tensor:
    """N(shift, scale) drawn on the CPU from `gen`, on the card."""
    t = torch.randn(*shape, generator=gen) * scale + shift
    return t.to("cuda", dtype)


def expect_caught(fault: str, check) -> None:
    """Run `check` on inputs with `fault` planted; raise unless the
    check fails."""
    try:
        check()
    except AssertionError as e:
        emit({"planted_fault": fault, "caught": True, "by": str(e)})
        return
    raise AssertionError(f"the check passed with {fault} planted")


def cab_check_weights(gen: torch.Generator, c: int = 96, mid: int = 32):
    """Kernel 7's weights for its check: a large LN bias (so a conv that
    saw LN(0) = ln bias outside the image would differ) and N(0, 0.5)
    conv biases."""
    return [rand(gen, c, scale=0.1, shift=1.0), rand(gen, c, scale=0.5),
            rand(gen, 3, 3, c, mid, scale=(2 / (9 * c)) ** 0.5,
                 dtype=torch.bfloat16),
            rand(gen, mid, scale=0.5),
            rand(gen, 3, 3, mid, c, scale=(2 / (9 * mid)) ** 0.5,
                 dtype=torch.bfloat16),
            rand(gen, c, scale=0.5)]


def lane_padded_cab_weights(gen: torch.Generator, cr: int = 96,
                            to: int = 128) -> list:
    """cab_check_weights at C cr, zero-padded to `to` lanes as
    infer/lane_pad.py pads them (the hidden width unpadded)."""
    cw = cab_check_weights(gen, cr, cr // 3)
    return [pad_lanes(cw[0], [0], to), pad_lanes(cw[1], [0], to),
            pad_lanes(cw[2], [2], to), cw[3], pad_lanes(cw[4], [3], to),
            pad_lanes(cw[5], [0], to)]


def cudnn_cab_weights(ws: list) -> list:
    """Kernel 7's weights for cudnn_cab: the conv kernels OIHW, as the
    state dict holds them."""
    return [ws[0], ws[1], ws[2].permute(3, 2, 0, 1).contiguous(), ws[3],
            ws[4].permute(3, 2, 0, 1).contiguous(), ws[5]]


def cudnn_cab(x: torch.Tensor, cw: list, c_real: int | None = None):
    """Kernel 7's function as the PyTorch calls SRTPU_XLA_CAB makes in
    its place (infer/fused_hat._cab_plain without the squeeze-excite):
    layer_norm, a cuDNN conv, GELU, a cuDNN conv. Kernel 7's yardstick;
    the port runs it only under that lever."""
    from superresolution_tpu_torch.infer.common import conv_nhwc
    from superresolution_tpu_torch.ops import hab

    y = hab.layer_norm(x, cw[0], cw[1], c_real)
    return conv_nhwc(F.gelu(conv_nhwc(y, cw[2], cw[3])), cw[4], cw[5])


def cab_bound(px: int, c: int, mid: int) -> tuple[float, str]:
    """Kernel 7's bound on px pixels at C c, hidden mid: 2 x 9 c mid MACs
    a pixel, x and out read and written once, the kernels read once."""
    return bound(2 * px * 2 * 9 * c * mid,
                 px * c * 2 * 2 + 2 * 9 * c * mid * 2)


def hab_check_weights(gen: torch.Generator, c: int = 96, nh: int = 6,
                      n: int = 64, mlp: int = 192) -> dict:
    """Kernel 8's weights for its check: q and k weights and a rel-pos
    bias large enough that the softmax is far from uniform (logits of
    about 2-3 standard deviations), nonzero biases and LN parameters."""
    bf = torch.bfloat16
    return {"ln1_s": rand(gen, c, scale=0.1, shift=1.0),
            "ln1_b": rand(gen, c, scale=0.1),
            "wqkv": torch.cat([rand(gen, c, c, scale=0.15, dtype=bf),
                               rand(gen, c, c, scale=0.15, dtype=bf),
                               rand(gen, c, c, scale=c ** -0.5, dtype=bf)],
                              1).contiguous(),
            "bqkv": rand(gen, 3 * c, scale=0.1),
            "rpb": rand(gen, nh, n, n),
            "wp": rand(gen, c, c, scale=c ** -0.5, dtype=bf),
            "bp": rand(gen, c, scale=0.1),
            "ln2_s": rand(gen, c, scale=0.1, shift=1.0),
            "ln2_b": rand(gen, c, scale=0.1),
            "w1": rand(gen, c, mlp, scale=c ** -0.5, dtype=bf),
            "b1": rand(gen, mlp, scale=0.1),
            "w2": rand(gen, mlp, c, scale=mlp ** -0.5, dtype=bf),
            "b2": rand(gen, c, scale=0.1)}


def check_cab(ws, x: torch.Tensor, tag: str,
              c_real: int | None = None) -> dict:
    """Kernel 7 against its plain version (in f32 on the bf16 inputs):
    the output and the GELU hidden map, which starts as NaN so a slice no
    launch writes fails; one call counted, one launch of the tensor-core
    body."""
    from superresolution_tpu_torch.ops import hab

    b, h, w, _ = x.shape
    hid = torch.full((b, h, w, ws[2].shape[-1]), float("nan"),
                     dtype=x.dtype, device=x.device)
    op = hab.fused_cab_convs
    before = (op.launches, op.tc_launches, op.direct_launches)
    got = hab.fused_cab_convs(x, ws, hidden=hid, c_real=c_real)
    if (op.launches, op.tc_launches, op.direct_launches) != (
            before[0] + 1, before[1] + 1, before[2]):
        raise AssertionError(f"fused_cab_convs/{tag}: not one call of one "
                             "tensor-core launch")
    hid_ref = torch.empty(hid.shape, device=x.device)
    ref = hab.fused_cab_convs_reference(x.float(), ws, hidden=hid_ref,
                                        c_real=c_real)
    res = compare(f"fused_cab_convs/{tag}", got, ref, TOL_KERNEL)
    compare(f"fused_cab_convs/{tag}/hidden", hid, hid_ref, TOL_KERNEL)
    return res


def cab_three_launches(x: torch.Tensor, ws, c_real: int | None = None):
    """Kernel 7's three-launch body (layernorm_kernel and two
    conv3x3_kernel), whatever the route rule says: its first form, still
    the body of the widths off the rule, timed live beside the new one."""
    from superresolution_tpu_torch.ops import _build

    b, h, w, c = x.shape
    mid = ws[2].shape[-1]
    y, hid, out = (torch.empty_like(x), torch.empty(
        (b, h, w, mid), dtype=x.dtype, device=x.device), torch.empty_like(x))
    _build.layernorm(x, ws[0], ws[1], y, c_real)
    _build.conv3x3(y, c, ws[2], ws[3], hid, 0, mid, geom=(b, h, w),
                   gelu=True)
    _build.conv3x3(hid, mid, ws[4], ws[5], out, 0, c, geom=(b, h, w))
    return out


# Kernel 7's three faults planted in its tensor-core body (_build.cab_tc's
# `plant`): pixels outside the image staged as LN(0) = ln bias, the
# hidden map not zeroed outside the image, a 1-pixel halo.
CAB_FAULTS = ("PLANT_CAB_LN_BORDER", "PLANT_CAB_HID_BORDER",
              "PLANT_CAB_HALO1")
CAB_WIDTHS = (("c120", 120, 40, None, (1, 2 * HYBRID_IN, 2 * HYBRID_IN)),
              ("c128_creal96", 128, 32, 96,
               (1, 2 * HYBRID_IN, 2 * HYBRID_IN)),
              ("ragged_c96", 96, 32, None, (2, 100, 70)))


def cab_times(x: torch.Tensor, ws, c_real: int | None = None) -> dict:
    """Kernel 7 timed beside its yardsticks on the same inputs: its first
    form (three launches, live), the plain version, the cuDNN composition
    SRTPU_XLA_CAB runs; its bound."""
    from superresolution_tpu_torch.ops import hab

    b, h, w, c = x.shape
    cw = cudnn_cab_weights(ws)
    b_ms, b_by = cab_bound(b * h * w, c, ws[2].shape[-1])
    return {"ms": time_ms(lambda: hab.fused_cab_convs(x, ws,
                                                      c_real=c_real), 20),
            "queued_ms": queued_ms(lambda: hab.fused_cab_convs(
                x, ws, c_real=c_real), 20),
            "three_launch_ms": time_ms(
                lambda: cab_three_launches(x, ws, c_real), 20),
            "plain_ms": time_ms(lambda: hab.fused_cab_convs_reference(
                x, ws, c_real=c_real), 10),
            "cudnn_ms": time_ms(lambda: cudnn_cab(x, cw, c_real), 20),
            "bound_ms": b_ms, "bound_by": b_by}


def check_cab_widths() -> dict:
    """Phase 6b: kernel 7 at the h200 class's C 120 (hidden 40), the lane
    pad's C 128 with c_real 96 (hidden 32) and a ragged [2,100,70,96]
    against its plain version within 0.02, its hidden map too, one
    tensor-core launch a call; each timed beside its yardsticks (cab_times)
    and its first form's three launches. Its own generator, so the other
    phases draw what they drew before. Returns the rows by geometry."""
    from superresolution_tpu_torch.ops import hab

    gen = torch.Generator().manual_seed(SEED + 12)
    out = {}
    for tag, c, mid, cr, shape in CAB_WIDTHS:
        ws = hab.cab_mma_weights(lane_padded_cab_weights(gen, cr, c) if cr
                                 else cab_check_weights(gen, c, mid))
        x = rand(gen, *shape, cr or c, dtype=torch.bfloat16)
        if cr:
            x = pad_lanes(x, [3], c)
        err = check_cab(ws, x, tag, cr)
        out[f"cab_{tag}"] = {"shape": list(x.shape),
                             "max_rel_err": err["max_rel_err"],
                             **cab_times(x, ws, cr)}
        emit({"phase": "kernel_time", "name": "fused_cab_convs",
              "geometry": tag, **out[f"cab_{tag}"]})
    return out


def check_hab(ws, x: torch.Tensor, cab: torch.Tensor, ids, tag: str) -> dict:
    """Kernel 8 against its plain version on the same bf16 inputs: the
    output, and out - x - cab (attention + MLP), which the identity
    terms would hide."""
    from superresolution_tpu_torch.ops import hab

    before = hab.fused_hab_block.launches
    got = hab.fused_hab_block(x, cab, 6, ws, ids)
    if hab.fused_hab_block.launches != before + 1:
        raise AssertionError("fused_hab_block did not count its launch")
    ref = hab.hab_body_reference(x, cab, ws, 6, ids)
    res = compare(f"fused_hab_block/{tag}", got, ref, TOL_HAB)
    ident = x.float() + cab.float()
    compare(f"fused_hab_block/{tag}/attn_mlp", got.float() - ident,
            ref.float() - ident, TOL_HAB)
    return res


def check_oca(q, k_map, v_map, bias, tag: str, ws: int = 8,
              ows: int = 12) -> dict:
    from superresolution_tpu_torch.ops import flash_oca as fo

    before = fo.flash_oca_gathered.launches
    got = fo.flash_oca_gathered(q, k_map, v_map, bias, 6, ws, ows)
    if fo.flash_oca_gathered.launches != before + 1:
        raise AssertionError("flash_oca_gathered did not count its launch")
    ref = fo.flash_oca_gathered_reference(q, k_map, v_map, bias, 6, ws, ows)
    return compare(f"flash_oca_gathered/{tag}", got, ref, TOL_HAB)


def check_hybrid_kernels(gen: torch.Generator) -> dict:
    """Phase 6: kernels 7, 8, 9 against their plain versions at a
    CHIPEQ-sized geometry, a ragged one and the main path's shapes, where
    each is timed; the planted faults at the first."""
    from superresolution_tpu_torch.models.hat_lite import shift_region_ids
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import flash_oca as fo
    from superresolution_tpu_torch.ops import hab
    from superresolution_tpu_torch.ops.unfold import (
        extract_overlapping_windows)

    bf = torch.bfloat16
    # kernel 8's dense weights packed once, as a model packs them
    cab_w = hab.cab_mma_weights(cab_check_weights(gen))
    hab_w = hab.mma_weights(hab_check_weights(gen))
    out = {}
    side = 2 * HYBRID_IN
    # (CAB [B,H,W]; HAB/OCA image batch and H x W, a multiple of 8)
    for geom, cab_shape, (b, h, w) in (
            ("chipeq", (2, 48, 64), (2, 32, 32)),
            # 39 windows (3 x 13): no multiple of any block size
            ("ragged", (1, 37, 45), (3, 8, 104)),
            ("main", (1, side, side), (1, side, side))):
        x = rand(gen, *cab_shape, 96, dtype=bf)
        e7 = check_cab(cab_w, x, geom)
        nw = (h // 8) * (w // 8)
        xw = rand(gen, b * nw, 64, 96, dtype=bf)
        cw = rand(gen, b * nw, 64, 96, scale=0.3, dtype=bf)
        ids = torch.as_tensor(shift_region_ids(h, w, 8, 4), device="cuda")
        e8 = max((check_hab(hab_w, xw, cw, i, f"{geom}/{name}")
                  for name, i in (("unmasked", None), ("masked", ids))),
                 key=lambda e: e["max_rel_err"])
        q = rand(gen, b * nw, 64, 96, scale=1.5, dtype=bf)
        k_map, v_map = (F.pad(rand(gen, b, h, w, 96, scale=1.5, dtype=bf),
                              (0, 0, 2, 2, 2, 2)).contiguous()
                        for _ in range(2))
        bias = rand(gen, 6, 64, 144)
        e9 = check_oca(q, k_map, v_map, bias, geom)
        if geom == "chipeq":  # each check again, on planted inputs
            ref7 = hab.fused_cab_convs_reference(x.float(), cab_w)
            ref8 = hab.hab_body_reference(xw, cw, hab_w, 6, ids)
            ref9 = fo.flash_oca_gathered_reference(q, k_map, v_map, bias, 6,
                                                   8, 12)
            no_ln_b, no_b1 = list(cab_w), list(cab_w)
            no_ln_b[1] = torch.zeros_like(cab_w[1])
            no_b1[3] = torch.zeros_like(cab_w[3])
            rpb_t = dict(hab_w, rpb=hab_w["rpb"].transpose(1, 2).contiguous())
            faults = {
                "cab_ln_bias_zeroed": (lambda: hab.fused_cab_convs(
                    x, no_ln_b), ref7, TOL_KERNEL),
                "cab_conv1_bias_zeroed": (lambda: hab.fused_cab_convs(
                    x, no_b1), ref7, TOL_KERNEL),
                "hab_region_ids_dropped": (lambda: hab.fused_hab_block(
                    xw, cw, 6, hab_w, None), ref8, TOL_HAB),
                "hab_rpb_transposed": (lambda: hab.fused_hab_block(
                    xw, cw, 6, rpb_t, ids), ref8, TOL_HAB),
                "oca_bias_zeroed": (lambda: fo.flash_oca_gathered(
                    q, k_map, v_map, torch.zeros_like(bias), 6, 8, 12),
                    ref9, TOL_HAB),
                "oca_k_map_shifted": (lambda: fo.flash_oca_gathered(
                    q, torch.roll(k_map, 1, 2), v_map, bias, 6, 8, 12),
                    ref9, TOL_HAB),
            }
            for fault, (kern, ref, tol) in faults.items():
                expect_caught(fault, lambda: compare(
                    f"planted/{fault}", kern(), ref, tol))
            # kernel 7's own faults, planted in its tensor-core body
            for fault in CAB_FAULTS:
                expect_margin(f"fused_cab_convs/{fault}", planted(
                    "cab_tc", getattr(_build, fault),
                    lambda: hab.fused_cab_convs(x, cab_w)), ref7, TOL_KERNEL)
            # kernel 8's own faults, planted in its tensor-core body
            for bit, fault in ((_build.PLANT_SKIP_SLAB, "qkv_slab_skipped"),
                               (_build.PLANT_NO_LN2, "ln2_skipped")):
                expect_margin(f"fused_hab_block/{fault}", planted(
                    "hab_block", bit, lambda: hab.fused_hab_block(
                        xw, cw, 6, hab_w, ids)), ref8, TOL_HAB)
        if geom != "main":
            continue

        px, tok = side * side, b * nw * 64
        map_bytes = 2 * k_map.numel() * 2
        sdpa_q = q.reshape(-1, 64, 6, 16).transpose(1, 2)
        frag9 = fo.bias_fragments(bias, 0.25)
        kw, vw = (extract_overlapping_windows(m, 8, 12, h // 8, w // 8)
                  .reshape(-1, 144, 6, 16).transpose(1, 2)
                  for m in (k_map, v_map))
        rows = [
            ("fused_cab_convs", "superresolution_tpu/ops/pallas_hab.py:462",
             e7, lambda: hab.fused_cab_convs(x, cab_w),
             lambda: hab.fused_cab_convs_reference(x, cab_w), None,
             2 * px * CAB_MACS, px * 96 * 2 * 2 + 2 * 9 * 96 * 32 * 2,
             list(x.shape), [CAB_SRC, ENGINE_SRC]),
            ("fused_hab_block", "superresolution_tpu/ops/pallas_hab.py:265",
             e8, lambda: hab.fused_hab_block(xw, cw, 6, hab_w, ids),
             lambda: hab.hab_body_reference(xw, cw, hab_w, 6, ids), None,
             2 * tok * HAB_MACS,
             tok * 96 * 2 * 3 + ids.numel() * 4
             + 2 * (96 * 288 + 96 * 96 + 2 * 96 * 192),
             list(xw.shape), [HAT_SRC, FLASH_SRC]),
            ("flash_oca_gathered",
             "superresolution_tpu/ops/pallas_flash_oca.py:165", e9,
             # the bias re-laid once, as a model passes it
             lambda: fo.flash_oca_gathered(q, k_map, v_map, bias, 6, 8, 12,
                                           fragments=frag9),
             lambda: fo.flash_oca_gathered_reference(q, k_map, v_map, bias,
                                                     6, 8, 12),
             # the same attention on the pre-gathered windows (the gather
             # itself is not in this call)
             lambda: F.scaled_dot_product_attention(
                 sdpa_q, kw, vw, attn_mask=bias.to(bf)),
             2 * tok * OCA_MACS, tok * 96 * 2 * 2 + map_bytes
             + bias.numel() * 4, list(q.shape), [OCA_SRC, FLASH_SRC, ENGINE_SRC]),
        ]
        for name, tpu, err, kern, plain, lib, flops, nbytes, shape, srcs \
                in rows:
            b_ms, b_by = bound(flops, nbytes)
            out[name] = {
                "name": name, "route": "cuda", "source": srcs[0],
                "sources": srcs, "replaces": tpu, "shape": shape,
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"],
                "tol": TOL_KERNEL if name == "fused_cab_convs" else TOL_HAB,
                "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 20),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if lib is None else time_ms(lib, 20)}
            extra = {}
            if name == "fused_cab_convs":
                extra = {k: v for k, v in cab_times(x, cab_w).items()
                         if k in ("queued_ms", "three_launch_ms",
                                  "cudnn_ms")}
                out[name]["ptxas"] = CAB_PTXAS or None
            if name == "fused_hab_block":
                out[name]["ptxas"] = ATTN_COPY_PTXAS.get("fused_hab_block")
            if name == "flash_oca_gathered":
                out[name]["ptxas"] = ATTN_COPY_PTXAS.get("oca_kernel")
                # on this line alone: the exponentials, and the call that
                # re-lays the bias itself
                extra = {**oca_exps(tok, 6, 144), "relay_ms": time_ms(
                    lambda: fo.flash_oca_gathered(q, k_map, v_map, bias, 6,
                                                  8, 12), 20)}
            emit({"phase": "kernel_time", **out[name], **extra})
            if name == "flash_oca_gathered":
                old_kernel(name, OCA_OLD, shape, OCA_OLD_MS["main"], "9")
            if name == "fused_hab_block":
                old_kernel(name, HAB_OLD, shape, HAB_OLD_MS["main"], "8")
            if name == "fused_cab_convs":
                kernel, ms, row = OLD_KERNELS[name]
                old_kernel(name, kernel, shape, ms, row)
    return out


def oca_exps(queries: int, heads: int, keys: int) -> dict:
    """Kernel 9's exponentials (one a logit) and the time the
    special-function units need for them at EXP_RATE."""
    exps = queries * heads * keys
    return {"exps": exps, "exp_floor_ms": exps / EXP_RATE * 1e3}


def old_kernel(name: str, kernel: str, shape, ms: float, row: str,
               **extra) -> None:
    """A redesigned kernel's predecessor's time at this shape, from
    PERF.md's kernel table (row `row`): printed as a reference, not
    re-run."""
    emit({"phase": "old_kernel", "name": name, **extra, "kernel": kernel,
          "shape": shape, "ms": ms, "from": f"PERF.md row {row}, not re-run"})


def pinned_dense_block(x, ws, r, slopes, seg=None):
    """B1's plain version with each lrelu replaced by a fixed slope map
    (1 or 0.2 per element, NHWC [B,H,W,4g]): equal to B1 wherever a
    pre-activation has the sign `slopes` gives it, and differentiable
    with exactly that lrelu' pattern. With `seg`, the masked per-stage
    chain of B1's plain seg form."""
    from superresolution_tpu_torch.ops.dense_trunk import image_rows

    g = ws[0][0].shape[-1]
    keep = 1.0 if seg is None else image_rows(
        x.shape[1], seg, x.device).to(x.dtype)[:, None]
    xc = x.permute(0, 3, 1, 2)
    feats = [xc * keep]
    sl = slopes.permute(0, 3, 1, 2)
    for j, (k, b) in enumerate(ws):
        y = F.conv2d(torch.cat(feats, 1), k.permute(3, 2, 0, 1), b,
                     padding=1)
        if j < 4:
            feats.append(y * sl[:, j * g:(j + 1) * g] * keep)
    out = xc + 0.2 * y
    if r is not None:
        out = r.permute(0, 3, 1, 2) + 0.2 * out
    return (out * keep).permute(0, 2, 3, 1)


def check_dense_backward(ws, x: torch.Tensor, res: torch.Tensor,
                         dout: torch.Tensor, tag: str) -> dict:
    """Kernel 13 through the training path's own op (autograd through
    fused_dense_block_train, so DenseBlockTrain's packing of the weights
    and its gradient order are checked too) against autograd through B1's
    plain version in f32 on the same (upcast) inputs, without and with
    `res`: the forward value and dx within TOL_KERNEL, each conv's dW and
    db within TOL_DW of the plain one's max, dres exactly.

    The f32 forward takes lrelu's slope pattern from the kernel's own
    bf16 y_1..y_4 (pinned_dense_block). Unpinned, a pre-activation that
    rounds to the other side of 0 in bf16 flips lrelu' between 1 and 0.2
    there; with the check's MSRA x 2 weights one such element moved dx
    by 0.17 of its max (0.0033 pinned), a jump of the function, not an
    error of the arithmetic. The unpinned distance is printed beside.
    Returns the worst dx check."""
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt

    b, h, w, _ = x.shape
    g = ws[0][0].shape[-1]
    y = torch.empty((b, h, w, 4 * g), dtype=x.dtype, device=x.device)
    dt.fused_dense_block(x, ws, workspace=y)
    slopes = torch.where(y.float() > 0, 1.0, 0.2)
    worst = []
    for suffix, r in (("", None), ("+residual", res)):
        name = f"dense_block_backward/{tag}{suffix}"
        kin = [t.detach().requires_grad_()
               for t in [x, *(t for pair in ws for t in pair)]
               + ([] if r is None else [r])]
        before = dtt.dense_block_backward.launches
        yk = dtt.fused_dense_block_train(
            kin[0], list(zip(kin[1:11:2], kin[2:11:2])),
            None if r is None else kin[-1])
        got = torch.autograd.grad(yk, kin, dout)
        if dtt.dense_block_backward.launches != before + 1:
            raise AssertionError(f"{name}: the call was not counted")
        leaves = [x.float().requires_grad_()]
        leaves += [t.float().requires_grad_() for pair in ws for t in pair]
        if r is not None:
            leaves.append(r.float().requires_grad_())
        wsf = list(zip(leaves[1:11:2], leaves[2:11:2]))
        rf = None if r is None else leaves[-1]
        out = pinned_dense_block(leaves[0], wsf, rf, slopes)
        ref = torch.autograd.grad(out, leaves, dout.float())
        unpinned = torch.autograd.grad(
            dt.fused_dense_block_reference(leaves[0], wsf, rf), leaves[0],
            dout.float())[0]
        compare(f"{name}/value", yk.detach(), out.detach(), TOL_KERNEL)
        worst.append(compare(f"{name}/dx", got[0], ref[0], TOL_KERNEL,
                             rel_err_unpinned=rel_err(got[0], unpinned)))
        for j in range(5):
            compare(f"{name}/dW{j + 1}", got[1 + 2 * j], ref[1 + 2 * j],
                    TOL_DW)
            compare(f"{name}/db{j + 1}", got[2 + 2 * j], ref[2 + 2 * j],
                    TOL_DW)
        if r is not None:
            compare(f"{name}/dres", got[-1], ref[-1], 0.0)
    return max(worst, key=lambda e: e["max_rel_err"])


def _planted_launches(fault: str):
    """Replace one of kernel 13's tensor-core launch helpers with a faulty
    one; returns (helper name, replacement)."""
    from superresolution_tpu_torch.ops import _build

    attr = {"dlrelu_slope_1": "grad_conv",
            "dacc5_without_s_acc": "dense_scale"}.get(fault, "wgrad_tc")
    real = getattr(_build, attr)
    if fault == "dlrelu_slope_1":
        def planted(*a, gate=None, gate_off=0, **kw):
            real(*a, **kw)  # the transposed convs lose their lrelu' gate
        return attr, planted
    if fault == "dacc5_without_s_acc":
        return attr, lambda src, scale, out: real(src, 1.0, out)

    def planted(in0, cin0, in1, cin1, d, d_off, cout, dw, db, **kw):
        real(in0, cin0, in1, cin1, d, d_off, cout, dw, db, **kw)
        if fault == "wgrad_taps_dy_swapped":
            dw.copy_(dw.flip(0))
        else:  # bias_grad_zeroed
            db.zero_()
    return attr, planted


def check_k13_bits(ws, x, res, dout, tag: str) -> None:
    """Two kernel 13 calls on the same inputs give the same bits of every
    dW and db (the weight grads sum fixed chunks in a fixed order)."""
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt

    a = dtt.dense_block_backward(x, ws, res, dout)[1]
    b = dtt.dense_block_backward(x, ws, res, dout)[1]
    same = all(torch.equal(p, q) for pa, pb in zip(a, b)
               for p, q in zip(pa, pb))
    emit({"check": f"dense_block_backward/{tag}/dW_db_bitwise",
          "identical": same})
    if not same:
        raise AssertionError(f"dense_block_backward/{tag}: two calls gave "
                             "different dW or db bits")


@contextlib.contextmanager
def k13_direct():
    """Kernel 13's own launches on the direct route, as the parent ran
    them: its module's view of the route rule answers False, while B1's
    recompute keeps the rule it reads in ops/dense_trunk."""
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt

    dtt.dense_trunk = type(dt)("dense_trunk_direct")
    dtt.dense_trunk.uses_tensor_cores = lambda x, c, g: False
    try:
        yield
    finally:
        dtt.dense_trunk = dt


# Kernel 13's launches by name, for its per-launch split: (part, name
# fragments), matched in order; anything else on the card is the glue.
K13_PARTS = (("recompute", ("DenseConv<",)),
             ("dense_scale", ("dense_scale",)),
             ("flip_weights", ("flip_weights",)),
             ("transposed_convs", ("DenseGradConv", "conv3x3_kernel")),
             ("wgrad_reduce", ("wgrad_reduce",)),
             ("wgrad", ("wgrad_tc_kernel", "wgrad_kernel")))


def backward_split(fn, calls: int = 3) -> dict:
    """Device ms and launches by K13_PARTS of one call of fn (a kernel 13
    call), the rest as glue (the torch ops around the kernels): the last
    of `calls` calls under torch.profiler, after a warm-up, found on the
    device timeline after a spin kernel launched just before it (the
    profiler can drop a block's first kernel records); and the host ms
    of the call before it, which waits on no spin. last_call_only False:
    no spin kernel was seen, and the parts are the block's means a
    call."""
    from superresolution_tpu_torch.utils.dma_probe import SPIN_CYCLES

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            if i == calls - 1:
                torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i == calls - 2:
                host_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(kernels) if "spin" in e.name.lower()
             or "sleep" in e.name.lower()]
    last = kernels[marks[-1] + 1:] if marks else kernels
    share = 1.0 if marks else 1.0 / calls
    ms = {k: 0.0 for k, _ in K13_PARTS}
    ms["glue"] = 0.0
    n = dict.fromkeys(ms, 0)
    glue = []
    for e in last:
        part = next((k for k, frags in K13_PARTS
                     if any(f in e.name for f in frags)), "glue")
        ms[part] += share * e.time_range.elapsed_us() / 1e3
        n[part] += 1
        if part == "glue":
            glue.append(e.name[:50])
    if not marks:
        n = {k: v / calls for k, v in n.items()}
    total = sum(ms.values())
    return {"host_ms": host_ms, "device_ms": total or None, "ms": ms,
            "launches": n, "last_call_only": bool(marks),
            "glue_share": ms["glue"] / total if total else None,
            "glue_kernels": sorted(set(glue))[:12]}


K13_FAULTS = ("dlrelu_slope_1", "wgrad_taps_dy_swapped",
              "dacc5_without_s_acc", "bias_grad_zeroed")


def check_star_l1(p: torch.Tensor, t: torch.Tensor, tag: str,
                  p_in=None, t_in=None, thr: float = 0.02) -> dict:
    """Kernel 14 through the training path's own op (autograd through
    star_weighted_l1_cuda): its value and gradient, for an upstream
    gradient of 1.7, against the plain version on p, t within TOL_STAR of
    its max. The op runs on p_in, t_in (default p, t) and threshold thr,
    where a fault is planted."""
    from superresolution_tpu_torch.losses.basic import star_weighted_l1
    from superresolution_tpu_torch.ops.star_l1 import star_weighted_l1_cuda

    g = torch.tensor(1.7, device="cuda")
    pk = (p if p_in is None else p_in).clone().requires_grad_()
    before = star_weighted_l1_cuda.launches
    val = star_weighted_l1_cuda(pk, t if t_in is None else t_in, thr, 500.0)
    (dp,) = torch.autograd.grad(val, pk, g)
    if star_weighted_l1_cuda.launches != before + 2:
        raise AssertionError(f"star_l1/{tag}: the passes were not counted")
    pr = p.clone().requires_grad_()
    ref = star_weighted_l1(pr, t)
    (ref_dp,) = torch.autograd.grad(ref, pr, g)
    res = compare(f"star_l1/{tag}/value", val.detach(), ref.detach(),
                  TOL_STAR)
    compare(f"star_l1/{tag}/grad", dp.reshape(-1)[:p.numel()].view_as(p),
            ref_dp, TOL_STAR)
    return res


def star_inputs(gen: torch.Generator, shape) -> tuple:
    """pred near target; targets mostly sky below 0.02, 5% stars above
    it and 2% exactly at the threshold 0.02 (as f32), so a >= compare
    would change the loss."""
    t = torch.rand(shape, generator=gen) * 0.018
    u = torch.rand(shape, generator=gen)
    t = torch.where(u < 0.05, 0.02 + torch.rand(shape, generator=gen), t)
    t = torch.where((u >= 0.05) & (u < 0.07), torch.tensor(0.02), t)
    p = t + torch.randn(shape, generator=gen) * 0.01
    return p.cuda(), t.cuda()


def check_f32_routes(gen: torch.Generator) -> dict:
    """Phase 9b (C4): B1 and kernel 13 with f32 activations (a model
    trained under precision "fp32") on the conv engine's direct body, at
    hybrid_astro's [4,128,128,64] (C 64, g 32) with a residual, against
    their plain f32 versions within TOL_F32 of max |plain|: B1's output,
    kernel 13's dx and every conv's dW and db (the plain backward is
    autograd of B1's plain version); every launch off the tensor cores;
    times beside the bf16 tensor-core calls at the same shape."""
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt

    shape = (TRAIN_BATCH, TRAIN_LR, TRAIN_LR, 64)
    ws = [(k.float(), b) for k, b in dense_check_weights(gen)]
    x, res, dout = (rand(gen, *shape, scale=sc) for sc in (0.2, 0.05, 1.0))
    b1, k13 = dt.fused_dense_block, dtt.dense_block_backward
    before = (b1.launches, b1.tc_launches, k13.launches, k13.tc_launches)
    got = b1(x, ws, res)
    compare("f32_route/fused_dense_block", got,
            dt.fused_dense_block_reference(x, ws, res), TOL_F32)
    dx, grads, _ = k13(x, ws, res, dout)
    leaves = [x.clone().requires_grad_()] + [
        t.clone().requires_grad_() for pair in ws for t in pair]
    ref = torch.autograd.grad(dt.fused_dense_block_reference(
        leaves[0], list(zip(leaves[1::2], leaves[2::2])), res), leaves, dout)
    worst = compare("f32_route/dense_block_backward/dx", dx, ref[0], TOL_F32)
    for j, (dk, db) in enumerate(grads, 1):
        for name, t, r in ((f"dW{j}", dk, ref[2 * j - 1]),
                           (f"db{j}", db, ref[2 * j])):
            e = compare(f"f32_route/dense_block_backward/{name}", t, r,
                        TOL_F32)
            worst = max(worst, e, key=lambda v: v["max_rel_err"])
    after = (b1.launches, b1.tc_launches, k13.launches, k13.tc_launches)
    # B1 5 launches, the backward's recompute 4; kernel 13 one call
    if (after[0] - before[0], after[1] - before[1], after[2] - before[2],
            after[3] - before[3]) != (9, 0, 1, 0):
        raise AssertionError(f"f32_route: launches {before} -> {after}, "
                             "expected 9 of B1 and 1 of 13, none on the "
                             "tensor cores")
    bws = dense_check_weights(gen)
    xb, rb, db_ = (t.to(torch.bfloat16) for t in (x, res, dout))
    times = {
        "b1_f32_ms": time_ms(lambda: b1(x, ws, res), 5),
        "b1_f32_plain_ms": time_ms(
            lambda: dt.fused_dense_block_reference(x, ws, res), 5),
        "b1_bf16_tc_ms": time_ms(lambda: b1(xb, bws, rb), 5),
        "k13_f32_ms": time_ms(lambda: k13(x, ws, res, dout), 3),
        "k13_bf16_tc_ms": time_ms(lambda: k13(xb, bws, rb, db_), 3)}
    b_ms, b_by = bound(2 * (B1_MACS + RECOMPUTE_MACS + B1_MACS)
                       * TRAIN_BATCH * TRAIN_LR ** 2 / 67e12 * PEAK_FLOPS,
                       0)
    res_line = {"shape": list(shape), "max_rel_err": worst["max_rel_err"],
                "tol": TOL_F32, **times,
                "k13_f32_bound_ms_at_67_tflops": b_ms}
    emit({"phase": "f32_routes", **res_line})
    return res_line


def check_train_kernels(gen: torch.Generator) -> dict:
    """Phase 9: kernels 13 and 14 against their plain versions, with the
    planted faults; timed at hybrid_astro's shapes."""
    from superresolution_tpu_torch.losses.basic import star_weighted_l1
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt

    bf = torch.bfloat16
    out = {}
    for geom, (b, h, w, c, g) in (
            ("chipeq", (2, 16, 20, 16, 8)), ("ragged", (1, 37, 45, 64, 32)),
            ("main", (TRAIN_BATCH, TRAIN_LR, TRAIN_LR, 64, 32))):
        ws = dense_check_weights(gen, c, g)
        x = rand(gen, b, h, w, c, scale=0.2, dtype=bf)
        res = rand(gen, b, h, w, c, scale=0.05, dtype=bf)
        dout = rand(gen, b, h, w, c, dtype=bf)
        tc0 = dtt.dense_block_backward.tc_launches
        e13 = check_dense_backward(ws, x, res, dout, geom)
        if dtt.dense_block_backward.tc_launches != tc0 + 2:
            raise AssertionError(f"dense_block_backward/{geom}: not on the "
                                 "tensor cores")
        check_k13_bits(ws, x, res, dout, geom)
        if geom == "chipeq":
            for fault in K13_FAULTS:
                attr, planted = _planted_launches(fault)
                real = getattr(_build, attr)
                setattr(_build, attr, planted)
                try:
                    expect_caught(fault, lambda: check_dense_backward(
                        ws, x, res, dout, f"fault:{fault}"))
                finally:
                    setattr(_build, attr, real)
        if geom != "main":
            continue
        px = b * h * w
        flat = [t for pair in ws for t in pair]
        leaves = [x.detach().requires_grad_()] + [
            t.detach().requires_grad_() for t in flat]
        wsl = list(zip(leaves[1::2], leaves[2::2]))

        def plain13():
            y = dt.fused_dense_block_reference(leaves[0], wsl)
            return torch.autograd.grad(y, leaves, dout)

        b13, by13 = bound(2 * px * (2 * B1_MACS + RECOMPUTE_MACS),
                          3 * px * c * 2 + 4 * B1_MACS + 8 * (4 * g + c))
        out["dense_block_backward"] = {
            "name": "dense_block_backward", "route": "cuda",
            "source": TRAIN_TC_SRC,
            "sources": [TRAIN_TC_SRC, TRAIN_SRC, DENSE_SRC, ENGINE_SRC],
            "replaces": "superresolution_tpu/ops/pallas_dense_trunk_vjp.py:386",
            "shape": [b, h, w, c], "max_abs_err": e13["max_abs_err"],
            "max_rel_err": e13["max_rel_err"], "tol": TOL_KERNEL,
            "ms": time_ms(lambda: dtt.dense_block_backward(x, ws, None, dout),
                          10),
            "plain_ms": time_ms(plain13, 10), "bound_ms": b13,
            "bound_by": by13, "library_ms": None,
            "parent_kernel": OLD_KERNELS["dense_block_backward"][0]}
        with k13_direct():
            out["dense_block_backward"]["parent_kernel_ms"] = time_ms(
                lambda: dtt.dense_block_backward(x, ws, None, dout), 10)
        split = {}
        for route in (False, True):
            with k13_direct() if not route else contextlib.nullcontext():
                split[route] = backward_split(
                    lambda: dtt.dense_block_backward(x, ws, None, dout))
            emit({"phase": "k13_split", "route": "tc" if route else "direct",
                  "shape": [b, h, w, c], **split[route]})
        # the events time calls queued back to back, which the host's
        # issue of a call's launches can outlast: the profiled device ms
        # beside
        out["dense_block_backward"].update(
            device_ms=split[True]["device_ms"],
            parent_kernel_device_ms=split[False]["device_ms"])
        emit({"phase": "kernel_time", **out["dense_block_backward"]})
        kernel, ms, row = OLD_KERNELS["dense_block_backward"]
        old_kernel("dense_block_backward", kernel, [b, h, w, c], ms, row)

    side = TRAIN_LR * TRAIN_SCALE
    worst = None
    for tag, shape in (("main", (TRAIN_BATCH, side, side, 1)),
                       ("ragged", (1_000_003,))):
        p, t = star_inputs(gen, shape)
        e14 = check_star_l1(p, t, tag)
        worst = e14 if worst is None else max(
            worst, e14, key=lambda e: e["max_rel_err"])
        if tag != "ragged":
            continue
        n, pad = p.numel(), -p.numel() % 65536
        planted = {
            "star_threshold_ge": lambda: check_star_l1(
                p, t, "fault:star_threshold_ge",
                thr=float(np.nextafter(np.float32(0.02), np.float32(0)))),
            "tail_counted_in_n": lambda: check_star_l1(
                p, t, "fault:tail_counted_in_n",
                p_in=F.pad(p, (0, pad)), t_in=F.pad(t, (0, pad))),
        }
        for fault, check in planted.items():
            expect_caught(fault, check)
        emit({"check": "star_l1/ragged_n", "n": n})
    p, t = star_inputs(gen, (TRAIN_BATCH, side, side, 1))
    g = torch.ones(1, device="cuda")
    lo, dp = torch.empty(1, device="cuda"), torch.empty_like(p)
    pr = p.clone().requires_grad_()

    def kern14():
        _build.star_l1_value(p, t, 0.02, 500.0, lo)
        _build.star_l1_grad(p, t, 0.02, 500.0, g, dp)

    def plain14():
        return torch.autograd.grad(star_weighted_l1(pr, t), pr)

    b14, by14 = bound(5 * p.numel(), 3 * p.numel() * 4)
    out["star_weighted_l1_cuda"] = {
        "name": "star_weighted_l1_cuda", "route": "cuda",
        "source": TRAIN_SRC, "sources": [TRAIN_SRC],
        "replaces": "superresolution_tpu/ops/pallas_loss.py:73",
        "shape": list(p.shape), "max_abs_err": worst["max_abs_err"],
        "max_rel_err": worst["max_rel_err"], "tol": TOL_STAR,
        "ms": time_ms(kern14, 50), "plain_ms": time_ms(plain14, 50),
        "bound_ms": b14, "bound_by": by14, "library_ms": None,
        "value_ms": time_ms(lambda: _build.star_l1_value(
            p, t, 0.02, 500.0, lo), 50),
        "grad_ms": time_ms(lambda: _build.star_l1_grad(
            p, t, 0.02, 500.0, g, dp), 50),
        # the card alone (the calls queued behind a spin)
        "queued_ms": queued_ms(kern14, 50),
        "value_queued_ms": queued_ms(lambda: _build.star_l1_value(
            p, t, 0.02, 500.0, lo), 50),
        "grad_queued_ms": queued_ms(lambda: _build.star_l1_grad(
            p, t, 0.02, 500.0, g, dp), 50),
        **star_one_launch(p, t)}
    emit({"phase": "kernel_time", **out["star_weighted_l1_cuda"]})
    kernel, ms, row = OLD_KERNELS["star_weighted_l1_cuda"]
    old_kernel("star_weighted_l1_cuda", kernel, list(p.shape), ms, row)
    return out


def star_one_launch(p: torch.Tensor, t: torch.Tensor) -> dict:
    """Kernel 14's forward through its op: one CUDA kernel a call (the
    device's kernels in a profile of one call), and two calls give the
    same value bits; raises otherwise."""
    from superresolution_tpu_torch.ops.star_l1 import star_weighted_l1_cuda

    with torch.no_grad():
        star_weighted_l1_cuda(p, t)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            first = star_weighted_l1_cuda(p, t)
            torch.cuda.synchronize()
        second = star_weighted_l1_cuda(p, t)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "memcpy" not in e.name.lower()
             and "memset" not in e.name.lower()]
    same = bool((first.view(torch.int32) == second.view(torch.int32)).all())
    res = {"forward_kernels": names, "same_bits": same}
    emit({"check": "star_l1/one_launch", **res})
    if len(names) != 1 or not same:
        raise AssertionError(f"star_l1: the forward is not one launch with "
                             f"the same bits each call: {res}")
    return res


def hybrid_model(gen: torch.Generator, output_size: int | None = 4 * HYBRID_IN,
                 num_blocks: int = 23, **hat):
    """bench_hybrid's HybridSR at full width, bf16, on the card, random
    weights with N(0, 0.02) biases; `hat` sets HATLite's attention flags
    (attn_f32, flash_attn) or overrides its geometry (H200_HAT, depths)."""
    from superresolution_tpu_torch.models.hat_lite import HATLite
    from superresolution_tpu_torch.models.hybrid import HybridSR
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet

    hat = dict(dict(embed_dim=96, depths=(6,) * 4, num_heads=(6,) * 4,
                    window_size=8), **hat)
    model = HybridSR(
        stage1=RRDBNet(scale=2, in_channels=1, out_channels=1, features=64,
                       num_blocks=num_blocks, growth=32,
                       upsampler="pixelshuffle", generator=gen),
        stage2=HATLite(scale=2, in_channels=1, out_channels=1,
                       generator=gen, **hat),
        output_size=output_size, smoothing="balanced")
    model = model.to(torch.bfloat16).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def hybrid_path(gen: torch.Generator, card: str) -> dict:
    """Phases 7 and 8: one frame through fused_hybrid_model with every
    launch counted, checked against the plain HybridSR; then times.
    Returns the launches per frame."""
    from superresolution_tpu_torch.infer.fused_hat import (
        fused_hybrid_model, make_fused_hat)
    from superresolution_tpu_torch.infer.common import hwio
    from superresolution_tpu_torch.infer.fused_trunk import fused_rrdb_model
    from superresolution_tpu_torch.ops import flash_oca as fo
    from superresolution_tpu_torch.ops import hab
    from superresolution_tpu_torch.ops.blur import anti_checkerboard
    from superresolution_tpu_torch.ops.dense_trunk import (
        dense_weights, fused_dense_block)
    from superresolution_tpu_torch.ops.phase_tail import (
        conv_last_phase, up2_hr)
    from superresolution_tpu_torch.ops.subpixel import conv3x3_depth_to_space

    model = hybrid_model(gen)
    params = model.state_dict()
    x = torch.rand((1, HYBRID_IN, HYBRID_IN, 1), generator=gen).to(
        "cuda", torch.bfloat16)
    fused = fused_hybrid_model(params, model)
    ops = {"fused_dense_block": fused_dense_block, "up2_hr": up2_hr,
           "conv_last_phase": conv_last_phase,
           "fused_cab_convs": hab.fused_cab_convs,
           "fused_hab_block": hab.fused_hab_block,
           "flash_oca_gathered": fo.flash_oca_gathered,
           "conv3x3_depth_to_space": conv3x3_depth_to_space,
           **unrouted_ops()}
    with torch.inference_mode():
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = fused(x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {k: op.launches for k, op in ops.items()}
        n_hab = sum(model.stage2.depths)
        expected = {"fused_dense_block": 69 * 5, "up2_hr": 0,
                    "conv_last_phase": 0, "fused_cab_convs": n_hab,
                    "fused_hab_block": n_hab,
                    "flash_oca_gathered": len(model.stage2.depths),
                    "conv3x3_depth_to_space": 0,
                    **{k: 0 for k in UNROUTED}}
        check_launches("hybrid", launches, expected)
        expect_attn_bodies("hybrid")
        side = 4 * HYBRID_IN
        if tuple(y.shape) != (1, side, side, 1):
            raise AssertionError(f"hybrid output shape {tuple(y.shape)}")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError("hybrid: non-finite output")
        emit({"phase": "hybrid_path", "output_shape": list(y.shape),
              "dtype": str(y.dtype), "first_run_s": first_s,
              "launches_per_frame": launches,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

        # Each stage, and the frame, against the plain HybridSR on the
        # same bf16 weights (f32 attention logits) within TOL_PATH. Stage
        # 2 and the frame get the kernel path's own stage-2 input: stage
        # 2 amplifies a relative change of its input several times. Each
        # line also gives both paths' distance from the plain model run
        # in f32: with random weights at this depth the bf16 plain model
        # itself strays 0.03-0.05 from it.
        sub = {k: {n[len(k) + 1:]: v for n, v in params.items()
                   if n.startswith(k + ".")} for k in ("stage1", "stage2")}
        s1 = fused_rrdb_model(sub["stage1"], model.stage1)
        s2 = make_fused_hat(sub["stage2"], model.stage2)
        model32 = copy.deepcopy(model).float()

        def finish(stage2, z):  # stage 2 and the smoothing after it
            z = anti_checkerboard(stage2(z), "balanced")
            return anti_checkerboard(z, "light")

        y1 = s1(x)
        z = anti_checkerboard(y1, "balanced")
        for name, got, plain, ref in (
                ("stage1", y1, model.stage1(x), model32.stage1(x.float())),
                ("stage2", s2(z), model.stage2(z), model32.stage2(z.float())),
                ("frame", y, finish(model.stage2, z),
                 finish(model32.stage2, z.float()))):
            compare(f"hybrid/{name}", got, plain, TOL_PATH,
                    rel_err_vs_f32=rel_err(got, ref),
                    plain_rel_err_vs_f32=rel_err(plain, ref))
        # the whole frame from x through both paths and in f32 (printed)
        frame_plain, frame_32 = model(x), model32(x.float())
        emit({"check": "hybrid/frame_end_to_end",
              "rel_err": rel_err(y, frame_plain),
              "rel_err_vs_f32": rel_err(y, frame_32),
              "plain_rel_err_vs_f32": rel_err(frame_plain, frame_32)})
        del model32, frame_32, frame_plain

        def host_s(fn, runs=3):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / runs

        frame_s = host_s(lambda: fused(x))
        s1_s = host_s(lambda: s1(x))
        s2_s = host_s(lambda: s2(z))
        plain_s = host_s(lambda: model(x))
        # B1 at stage 1's shape (its kernel_time row is the ESRGAN one's)
        feat = rand(gen, 1, HYBRID_IN, HYBRID_IN, 64, scale=0.2,
                    dtype=torch.bfloat16)
        b1_w = dense_weights(
            [hwio(params[f"stage1.body.0.rdb1.conv{j}.weight"])
             for j in range(1, 6)],
            [params[f"stage1.body.0.rdb1.conv{j}.bias"] for j in range(1, 6)],
            device="cuda")
        b1_ms = time_ms(lambda: fused_dense_block(feat, b1_w), 20)
        # device time of one frame by kernel, from the profiler
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fused(x)
            torch.cuda.synchronize()
        on_card = sorted((e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        device_us = sum(e.self_device_time_total for e in on_card)
        top = [{"kernel": e.key[:60], "ms": e.self_device_time_total / 1e3,
                "count": e.count} for e in on_card[:10]]
    emit({"phase": "hybrid_times", "card": card, "frame_ms": frame_s * 1e3,
          "mp_per_s": HYBRID_IN ** 2 / 1e6 / frame_s,
          "stage1_ms": s1_s * 1e3, "stage2_ms": s2_s * 1e3,
          "plain_frame_ms": plain_s * 1e3, "b1_ms_stage1_shape": b1_ms,
          # None when the profiler saw no device time
          "device_ms_per_frame": device_us / 1e3 if device_us else None,
          "device_busy_share": (device_us / 1e3 / (frame_s * 1e3)
                                if device_us else None),
          "top_device_kernels": top,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return launches


# Kernels 12 and 16-19 run from their own entry points only: no path of
# the system calls them. Every path's run adds its counts of them here
# and fails unless they are 0; the kernels line reports the sums.
UNROUTED = ("fused_cab_convs_pair", "fused_dense_block_valid",
            "anti_checkerboard_kernel", "pack_conv3x3", "passthrough")
UNROUTED_SEEN = {k: 0 for k in UNROUTED}
UNROUTED_PATHS: list = []


def note_unrouted(tag: str, launches: dict) -> None:
    """Adds a system path's launches of kernels 12 and 16-19 to the tally;
    raises unless each was counted in that run and is 0, or unless B1's
    and B2's launches all took the tensor-core body (expect_tc_bodies)."""
    missing = [k for k in UNROUTED if k not in launches]
    if missing:
        raise AssertionError(f"{tag}: kernels {missing} not counted")
    for k in UNROUTED:
        UNROUTED_SEEN[k] += launches[k]
    UNROUTED_PATHS.append(tag)
    bad = {k: launches[k] for k in UNROUTED if launches[k]}
    if bad:
        raise AssertionError(f"{tag}: unrouted kernels launched {bad}")
    expect_tc_bodies(tag)


def unrouted_ops() -> dict:
    ops = counted_ops()
    return {k: ops[k] for k in UNROUTED}


def check_launches(tag: str, launches: dict, expected: dict,
                   system: bool = True) -> None:
    """launches == expected; a system path's run (every caller but the
    entry points of phases 23 and 35-38) also goes into the kernels 12
    and 16-19 tally (note_unrouted)."""
    if system:
        note_unrouted(tag, launches)
    if launches != expected:
        raise AssertionError(f"{tag} launches {launches} != expected "
                             f"{expected}")


# B1's, B2's, kernel 6's and kernel 13's launches by body on each counted
# system path: {path: {op: {"launches", "tc_launches",
# "direct_launches"}}}.
BODY_OPS = ("fused_dense_block", "up2_hr", "fused_rrdb",
            "dense_block_backward", "fused_cab_convs")
BODIES: dict = {}


def expect_tc_bodies(tag: str) -> dict:
    """Prints B1's, B2's, kernel 6's and kernel 13's launches by body
    since their counts were last zeroed (one line a path, as
    kernel15_bodies) and records them in BODIES; raises unless every
    launch went through the tensor-core body."""
    ops = counted_ops()
    res = {k: by_body(ops[k]) for k in BODY_OPS}
    BODIES[tag] = res
    emit({"check": f"{tag}/tc_bodies", **res})
    bad = {k: v for k, v in res.items()
           if v["direct_launches"] or v["tc_launches"] != v["launches"]}
    if bad:
        raise AssertionError(f"{tag}: B1 / B2 / 6 / 13 launches not all "
                             f"on the tensor cores: {bad}")
    return res


def train_config():
    """hybrid_astro at full width and depth, cut to a run of TRAIN_STEPS
    steps and one eval over 2 * TRAIN_BATCH synthetic pairs."""
    import dataclasses

    from superresolution_tpu_torch.utils.config import get_preset

    cfg = get_preset("hybrid_astro")
    data = dataclasses.replace(cfg.data, synthetic_len=2 * TRAIN_BATCH,
                               num_workers=4)
    train = dataclasses.replace(cfg.train, epochs=1,
                                steps_per_epoch=TRAIN_STEPS, eval_every=1,
                                resume=False)
    return cfg.replace(data=data, train=train)


def train_ops() -> dict:
    """Every kernel wrapper's launch counter holder, by kernel name."""
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt
    from superresolution_tpu_torch.ops import flash_oca as fo
    from superresolution_tpu_torch.ops import hab
    from superresolution_tpu_torch.ops import phase_tail as pt
    from superresolution_tpu_torch.ops import star_l1 as sl
    from superresolution_tpu_torch.ops import subpixel

    return {"fused_dense_block": dt.fused_dense_block,
            "up2_hr": pt.up2_hr, "conv_last_phase": pt.conv_last_phase,
            "fused_cab_convs": hab.fused_cab_convs,
            "fused_hab_block": hab.fused_hab_block,
            "flash_oca_gathered": fo.flash_oca_gathered,
            "dense_block_backward": dtt.dense_block_backward,
            "star_weighted_l1_cuda": sl.star_weighted_l1_cuda,
            "conv3x3_depth_to_space": subpixel.conv3x3_depth_to_space,
            **unrouted_ops()}


def step_grads(tr, apply, policy, lr, hr, kernel_loss: bool):
    """(loss, {name: grad}) of one step on (lr, hr) at the trainer's f32
    masters, with the forward `apply` under `policy`; the loss is the
    trainer's own (kernel 14 for a star-weighted L1) or, with
    kernel_loss False, the plain star-weighted L1 where the trainer's is
    one (else the trainer's, which runs no kernel)."""
    from superresolution_tpu_torch.losses.basic import star_weighted_l1

    leaves = {k: v.detach().requires_grad_()
              for k, v in tr.state.params.items()}
    pred = apply(policy.cast_to_compute(leaves),
                 lr.to(policy.compute_dtype)).float()
    lc = tr.cfg.loss
    loss = (star_weighted_l1(pred, hr.float(), lc.star_threshold,
                             lc.star_weight)
            if not kernel_loss and "star_l1" in lc.terms
            else tr.loss_fn(pred, hr.float())[0])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def check_train_step(tr, lr, hr, tag: str, prefixes=None,
                     against: str = "bf16") -> None:
    """One step through the kernels (the trainer's fused apply and loss)
    against the same step through the plain model in bf16 (or, with
    against="f32", in f32), on the same f32 masters and batch: the loss
    within TOL_STEP_LOSS, the global grad norm within TOL_STEP_GNORM,
    and, for each parameter under `prefixes` (default leaf_prefixes:
    conv_first, the first, middle and last RRDB, conv_body, stage 2's
    conv_first), its gradient within TOL_LEAF of max |plain|. Each line
    also gives both paths' distance from the plain step in f32 and the
    kernel path's from the plain bf16 step."""
    from torch.func import functional_call

    from superresolution_tpu_torch.train.state import global_norm
    from superresolution_tpu_torch.utils.precision import get_policy

    def plain(p, x):
        return functional_call(tr.model, p, (x,))

    bf16, f32 = get_policy("bf16"), get_policy("fp32")
    lk, gk = step_grads(tr, tr.fused_apply, bf16, lr, hr, True)
    if not bool(torch.isfinite(lk)) or not all(
            bool(torch.isfinite(g).all()) for g in gk.values()):
        raise AssertionError(f"train_step/{tag}: non-finite loss or grads")
    lp, gp = step_grads(tr, plain, bf16, lr, hr, False)
    l32, g32 = step_grads(tr, plain, f32, lr, hr, False)
    lref, gref = (lp, gp) if against == "bf16" else (l32, g32)
    compare(f"train_step/{tag}/loss", lk, lref, TOL_STEP_LOSS,
            against=against, rel_err_vs_f32=rel_err(lk, l32),
            plain_rel_err_vs_f32=rel_err(lp, l32),
            rel_err_vs_plain_bf16=rel_err(lk, lp))
    nk, np_, n32 = global_norm(gk), global_norm(gp), global_norm(g32)
    compare(f"train_step/{tag}/grad_norm", nk, np_ if against == "bf16"
            else n32, TOL_STEP_GNORM, against=against,
            rel_err_vs_f32=rel_err(nk, n32),
            plain_rel_err_vs_f32=rel_err(np_, n32),
            rel_err_vs_plain_bf16=rel_err(nk, np_))
    for pre in prefixes or leaf_prefixes(tr.model.stage1.num_blocks):
        # one line per group of leaves: its worst leaf, with the worst
        # distances from f32 of either path over the group
        errs = sorted((rel_err(gk[k], gref[k]), k) for k in gk
                      if k.startswith(pre))
        worst, k = errs[-1]
        line = {"check": f"train_step/{tag}/grad/{pre}*",
                "leaves": len(errs), "worst_leaf": k, "max_rel_err": worst,
                "tol": TOL_LEAF, "against": against,
                "rel_err_vs_f32": max(rel_err(gk[n], g32[n])
                                      for _, n in errs),
                "plain_rel_err_vs_f32": max(rel_err(gp[n], g32[n])
                                            for _, n in errs),
                "rel_err_vs_plain_bf16": max(rel_err(gk[n], gp[n])
                                             for _, n in errs)}
        emit(line)
        if worst > TOL_LEAF:
            raise AssertionError(f"train_step/{tag}: gradient of {k} is "
                                 f"{worst} of max |plain| > {TOL_LEAF}")


def fp32_fused_step(lr: torch.Tensor, hr: torch.Tensor) -> dict:
    """Phase 10b (C4): a Trainer on hybrid_astro with precision "fp32" and
    fused_trunk True takes one step of its fit (the fused train apply: B1
    and kernel 13 in f32 on the conv engine's direct body; launches
    counted, none on the tensor cores); then that step's loss and every
    gradient against the plain f32 step on the same masters and batch,
    within TOL_FP32_STEP of max |plain| (the loss, and the worst leaf of
    each leaf_prefixes group and of all leaves)."""
    import dataclasses

    from torch.func import functional_call

    from superresolution_tpu_torch.train.trainer import Trainer

    cfg = train_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, precision="fp32", fused_trunk=True))
    with Trainer(cfg, TRAIN_DIR + "_fp32") as tr:
        if tr.fused_apply is None or tr.policy.compute_dtype != torch.float32:
            raise AssertionError("fp32_step: not the fused fp32 trainer")
        nb = tr.model.stage1.num_blocks
        ops = train_ops()
        zero_counts()
        t0 = time.perf_counter()
        tr.state, logs = tr._train_step(tr.state, {"lr": lr, "hr": hr},
                                        None)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = {k: op.launches for k, op in ops.items()}
        # not a tensor-core path: system=False keeps it out of the
        # tc_bodies rule (kernels 12, 16-19 are held at 0 by `expected`)
        check_launches("fp32_step", launches, {
            k: {"fused_dense_block": 3 * nb * 9, "dense_block_backward":
                3 * nb, "star_weighted_l1_cuda": 2}.get(k, 0) for k in ops},
            system=False)
        dt_, dtt_ = ops["fused_dense_block"], ops["dense_block_backward"]
        if dt_.tc_launches or dtt_.tc_launches:
            raise AssertionError("fp32_step: a launch took the tensor cores")
        loss = float(logs["total"]) if "total" in logs else None

        def plain(p, x):
            return functional_call(tr.model, p, (x,))

        lk, gk = step_grads(tr, tr.fused_apply, tr.policy, lr, hr, True)
        l32, g32 = step_grads(tr, plain, tr.policy, lr, hr, False)
        compare("fp32_step/loss", lk, l32, TOL_FP32_STEP)
        groups = {pre: max((rel_err(gk[k], g32[k]), k) for k in gk
                           if k.startswith(pre))
                  for pre in (*leaf_prefixes(nb), "")}
        for pre, (err, k) in groups.items():
            emit({"check": f"fp32_step/grad/{pre or 'every_leaf'}*",
                  "worst_leaf": k, "max_rel_err": err,
                  "tol": TOL_FP32_STEP})
            if err > TOL_FP32_STEP:
                raise AssertionError(f"fp32_step: gradient of {k} is {err} "
                                     f"of max |plain| > {TOL_FP32_STEP}")
    res = {"step_s": step_s, "logged_loss": loss,
           "loss_rel_err": rel_err(lk, l32),
           "worst_leaf_rel_err": groups[""][0], "launches": {
               k: v for k, v in launches.items() if v}}
    emit({"phase": "fp32_step", **res})
    return res


def leaf_prefixes(nb: int) -> tuple:
    return ("stage1.conv_first.", "stage1.body.0.",
            f"stage1.body.{nb // 2}.", f"stage1.body.{nb - 1}.",
            "stage1.conv_body.", "stage2.conv_first.")


def train_path(card: str) -> dict:
    """Phases 10 and 11: the Trainer on hybrid_astro at full width, its
    launches counted; one step held against the plain model; then times.
    Returns the launches of the fit."""
    import shutil

    from superresolution_tpu_torch.data.loader import prefetch_to_device
    from superresolution_tpu_torch.train.trainer import Trainer

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    ops = train_ops()
    with Trainer(train_config(), TRAIN_DIR) as tr:
        if tr.fused_apply is None:
            raise AssertionError("the Trainer did not turn the fused "
                                 "train apply on")
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = tr.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {k: op.launches for k, op in ops.items()}
        nb = tr.model.stage1.num_blocks
        per_step = {"fused_dense_block": 3 * nb * (5 + 4),
                    "dense_block_backward": 3 * nb,
                    "star_weighted_l1_cuda": 2}
        check_launches("train", launches,
                       {k: TRAIN_STEPS * per_step.get(k, 0) for k in ops})
        if out["final_step"] != TRAIN_STEPS:
            raise AssertionError(f"fit took {out['final_step']} steps")
        with open(f"{TRAIN_DIR}/logs/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        train_log = next(r for r in recs if "train/total" in r)
        val_psnr = out["best"]["psnr"]
        if not all(np.isfinite([train_log["train/total"],
                                train_log["train/grad_norm"], val_psnr])):
            raise AssertionError(f"train: non-finite loss, grad norm or "
                                 f"PSNR {train_log} {val_psnr}")
        meta_path = f"{TRAIN_DIR}/checkpoints/meta.json"
        with open(meta_path) as f:
            meta = json.load(f)
        ckpt = f"{TRAIN_DIR}/checkpoints/step_{TRAIN_STEPS:010d}/state.pt"
        if meta["last_step"] != TRAIN_STEPS or not os.path.exists(ckpt):
            raise AssertionError(f"no checkpoint at step {TRAIN_STEPS}")
        emit({"phase": "train_path", "steps": TRAIN_STEPS, "fit_s": fit_s,
              "launches": launches,
              "launches_per_step": {k: v // TRAIN_STEPS
                                    for k, v in launches.items()},
              "train_loss": train_log["train/total"],
              "train_grad_norm": train_log["train/grad_norm"],
              "val_psnr": val_psnr, "val_ssim": out["best"]["ssim"],
              "checkpoint": ckpt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

        # one fixed batch (the first validation batch, no augmentation)
        batch = next(iter(prefetch_to_device(tr.val_loader)))
        lr, hr = batch["lr"], batch["hr"]
        check_train_step(tr, lr, hr, f"{nb}_rrdbs")
        emit({"phase": "train_times", **train_times(tr, lr, hr, card)})
    fp32_fused_step(lr, hr)
    return launches


def train_times(tr, lr, hr, card: str) -> dict:
    """Phase 11: per step on one device-resident batch, after a warm-up,
    over TIME_STEPS steps ending in torch.cuda.synchronize(): the
    trainer's step, stage 1 and stage 2 forward + backward, the plain
    step; device time by kernel (torch.profiler) and the busy share of a
    step; peak memory."""
    from torch.func import functional_call

    from superresolution_tpu_torch.ops.blur import anti_checkerboard
    from superresolution_tpu_torch.train.fused_apply import (
        make_fused_train_apply)
    from superresolution_tpu_torch.train.steps import make_train_step

    batch = {"lr": lr, "hr": hr}

    def host_ms(fn, runs=TIME_STEPS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / runs * 1e3

    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(lambda: tr._train_step(tr.state, batch, None))
    peak = torch.cuda.max_memory_allocated() / 2**30
    p = tr.policy.cast_to_compute(
        {k: v.detach().requires_grad_() for k, v in tr.state.params.items()})
    s1 = {k[7:]: v for k, v in p.items() if k.startswith("stage1.")}
    s2 = {k[7:]: v for k, v in p.items() if k.startswith("stage2.")}
    x = lr.to(torch.bfloat16)
    s1_apply = make_fused_train_apply(tr.model.stage1)
    z = anti_checkerboard(s1_apply(s1, x), "balanced").detach()

    def stage1_fb():
        y = s1_apply(s1, x)
        torch.autograd.grad(y.float().sum(), list(s1.values()))

    def stage2_fb():
        y = functional_call(tr.model.stage2, s2, (z,))
        torch.autograd.grad(y.float().sum(), list(s2.values()))

    s1_ms, s2_ms = host_ms(stage1_fb), host_ms(stage2_fb)
    plain_step = make_train_step(tr.model, tr.loss_fn, tr.tx, tr.policy,
                                 tr.eval_input_fn)
    plain_ms = host_ms(lambda: plain_step(tr.state, batch, None))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr._train_step(tr.state, batch, None)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    on_card = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    top = [{"kernel": e.key[:60], "ms": e.self_device_time_total / 1e3,
            "count": e.count} for e in on_card[:12]]
    return {"card": card, "batch": TRAIN_BATCH, "steps_timed": TIME_STEPS,
            "ms_per_step": step_ms,
            "samples_per_s": TRAIN_BATCH / step_ms * 1e3,
            "input_mp_per_s": TRAIN_BATCH * TRAIN_LR ** 2 / step_ms / 1e3,
            "stage1_fwd_bwd_ms": s1_ms, "stage2_fwd_bwd_ms": s2_ms,
            "plain_step_ms": plain_ms,
            "profiled_step_ms": prof_ms,
            "device_ms_per_step": device_ms if device_ms else None,
            "device_busy_share": device_ms / prof_ms if device_ms else None,
            "top_device_kernels": top, "peak_mem_gib": peak}


# ---- 12-15: the public upscale API over the flash hybrid, kernel 10 ----

def counted_ops() -> dict:
    """Every hand kernel's wrapper, by name, with its launch count."""
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt
    from superresolution_tpu_torch.ops import flash_oca as fo
    from superresolution_tpu_torch.ops import hab, hab_strip
    from superresolution_tpu_torch.ops.blur import anti_checkerboard_kernel
    from superresolution_tpu_torch.ops.dense_trunk import fused_dense_block
    from superresolution_tpu_torch.ops.dense_valid import (
        fused_dense_block_valid)
    from superresolution_tpu_torch.ops.pairconv import pack_conv3x3
    from superresolution_tpu_torch.ops.phase_tail import (
        conv_last_phase, up2_hr)
    from superresolution_tpu_torch.ops.star_l1 import star_weighted_l1_cuda
    from superresolution_tpu_torch.ops.subpixel import conv3x3_depth_to_space
    from superresolution_tpu_torch.ops.window_attention import (
        flash_window_attention)
    from superresolution_tpu_torch.utils.dma_probe import passthrough

    from superresolution_tpu_torch.ops import dense_trunk as dt

    return {"fused_dense_block": fused_dense_block, "up2_hr": up2_hr,
            "conv_last_phase": conv_last_phase,
            "fused_dense_block_prologue": dt.fused_dense_block_prologue,
            "fused_dense_block_epilogue": dt.fused_dense_block_epilogue,
            "fused_rrdb": dt.fused_rrdb,
            "fused_cab_convs": hab.fused_cab_convs,
            "fused_hab_block": hab.fused_hab_block,
            "flash_oca_gathered": fo.flash_oca_gathered,
            "strip_hab_block": hab_strip.strip_hab_block,
            "fused_cab_convs_pair": hab.fused_cab_convs_pair,
            "dense_block_backward": dtt.dense_block_backward,
            "star_weighted_l1_cuda": star_weighted_l1_cuda,
            "flash_window_attention": flash_window_attention,
            "conv3x3_depth_to_space": conv3x3_depth_to_space,
            "fused_dense_block_valid": fused_dense_block_valid,
            "anti_checkerboard_kernel": anti_checkerboard_kernel,
            "pack_conv3x3": pack_conv3x3, "passthrough": passthrough}


def zero_counts() -> dict:
    """Every counted kernel's launches set to 0, the conv engine's
    per-body counts (B1, B2, kernels 15 and 18) too."""
    from superresolution_tpu_torch.ops import window_attention as wa

    ops = counted_ops()
    for op in ops.values():
        op.launches = 0
        if hasattr(op, "tc_launches"):
            op.tc_launches = op.direct_launches = 0
    wa.flash_map_attention.launches = 0
    return ops


def expect_attn_bodies(tag: str, map_calls: int | None = None) -> dict:
    """Prints kernels 8, 10 and 11's launches since their counts were
    zeroed (8 and 11 have one body, on the tensor cores); raises unless
    every launch of kernel 10 took the tensor cores and, when map_calls is
    given, its map form ran that many times (one a HAB)."""
    from superresolution_tpu_torch.ops import window_attention as wa

    ops = counted_ops()
    k10 = ops["flash_window_attention"]
    res = {"flash_window_attention": {"launches": k10.launches,
                                      "tc_launches": k10.tc_launches},
           "flash_map_attention": wa.flash_map_attention.launches,
           "fused_hab_block": ops["fused_hab_block"].launches,
           "strip_hab_block": ops["strip_hab_block"].launches}
    emit({"check": f"{tag}/attn_tc_bodies", **res})
    if k10.tc_launches != k10.launches or (
            map_calls is not None
            and res["flash_map_attention"] != map_calls):
        raise AssertionError(f"{tag}: kernel 10 not all on the tensor cores"
                             f" or map form calls != {map_calls}: {res}")
    return res


def expect_tc_body(tag: str, op) -> dict:
    """Raises unless every launch of `op` (B1, B2, kernel 15 or 18) since
    its counts were zeroed went through the tensor-core body."""
    res = by_body(op)
    if op.tc_launches != op.launches or op.direct_launches:
        raise AssertionError(f"{tag}: {res}, not all on the tensor cores")
    return res


# The conv engine's kernels in nvcc's -Xptxas -v report (main fills it
# from the build; policies Subpixel 15, PackConv 18, DenseStage 16,
# DenseConv B1, PhaseUp B2, DenseGradConv 13's transposed convs): {policy:
# {body: {"<type>_<columns>[_drop]":
# {"registers": n, "spill_bytes": b}}}}; the tensor-core body must not
# spill.
PTXAS: dict = {}


def ptxas_usage(report: str) -> dict:
    out: dict = {}
    lines = report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(r"Compiling entry function '\S*?(conv_tc_kernel|conv_kernel)"
                      r"I\S*?(Subpixel|PackConv|DenseStage|DenseConv|PhaseUp|"
                      r"DenseGradConv)"
                      r"(?:I(13__nv_bfloat16|f)E)?ELi(\d+)E(Lb([01])E)?",
                      line)
        if not k:
            continue
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        key = (("f32_" if k.group(3) == "f" else "bf16_") + k.group(4)
               + ("_drop" if k.group(6) == "1" else ""))
        body = "tc" if k.group(1) == "conv_tc_kernel" else "direct"
        out.setdefault(k.group(2), {}).setdefault(body, {})[key] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": int(spill.group(1)) if spill else None}
    spilled = {p: {k: v for k, v in b.get("tc", {}).items()
                   if v["spill_bytes"]} for p, b in out.items()}
    if any(spilled.values()):
        raise AssertionError(f"the tensor-core body spills: {spilled}")
    return out


# Kernel 6's persistent rrdb_tc_kernel and kernel 13's wgrad_tc_kernel
# (by its CO columns) and flip_weights_kernel in the same report:
# {kernel: {"registers": n, "spill_bytes": b}}; printed, and rrdb_tc_kernel
# (the conv engine's tile body) must not spill.
CHAIN_GRAD_PTXAS: dict = {}


def chain_grad_ptxas(report: str) -> dict:
    out: dict = {}
    lines = report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(r"Compiling entry function '\S*?(rrdb_tc_kernel|"
                      r"wgrad_tc_kernelILi(\d+)E|flip_weights_kernel)", line)
        if not k:
            continue
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        name = (f"wgrad_tc_kernel<{k.group(2)}>" if k.group(2)
                else k.group(1))
        out[name] = {"registers": int(regs.group(1)) if regs else None,
                     "spill_bytes": int(spill.group(1)) if spill else None}
    if (out.get("rrdb_tc_kernel") or {}).get("spill_bytes"):
        raise AssertionError(f"rrdb_tc_kernel spills: {out}")
    return out


# Kernels 17 and B3 in the same report: {"blur_kernel": {"<type>_k<k>_
# <taps>": {...}}, "conv_last_kernel": {"cout<n>": {...}}} (taps: 0 C 1
# rows, 1 aligned vectors, 2 scalar); neither may spill.
STENCIL_PTXAS: dict = {}
BLUR_TAPS = ("row", "vec", "scalar")


def stencil_ptxas(report: str) -> dict:
    out: dict = {}
    lines = report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(r"Compiling entry function '\S*?(blur_kernel|"
                      r"conv_last_kernel)I(13__nv_bfloat16|f)?Li(\d+)E"
                      r"(Li(\d)E)?", line)
        if not k:
            continue
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        key = (f"cout{k.group(3)}" if k.group(1) == "conv_last_kernel" else
               ("bf16" if "bfloat16" in k.group(2) else "f32")
               + f"_k{k.group(3)}_{BLUR_TAPS[int(k.group(5))]}")
        out.setdefault(k.group(1), {})[key] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": int(spill.group(1)) if spill else None}
    spilled = {n: {k: v for k, v in d.items() if v["spill_bytes"]}
               for n, d in out.items()}
    if any(spilled.values()):
        raise AssertionError(f"kernel 17 or B3 spills: {spilled}")
    return out


# Kernels 9 and 19 in the same report: {"oca_kernel": {"c<C>_nh<heads>_
# ws<ws>_ows<ows>[_planted]": {...}}, "copy_kernel": {...}}; neither may
# spill.
ATTN_COPY_PTXAS: dict = {}


# flash_tc.cuh's FlashAttention-2 instances by the way they address their
# keys: kernel 9's (the padded maps), kernel 10's (windows, the map)
FLASH_MODES = ("oca_kernel", "attn_window_tc", "attn_map_tc")


def attn_copy_ptxas(report: str) -> dict:
    """Kernels 9 and 10's flash_kernel instances (by mode), kernels 8 and
    11's hab_kernel and kernel 19's copy_kernel in nvcc's report:
    registers and spills (printed); none of 9's or 19's may spill."""
    out: dict = {}
    lines = report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(r"Compiling entry function '\S*?(flash_kernelILi(\d+)"
                      r"ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d)ELb([01])E|"
                      r"hab_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])"
                      r"E|copy_kernel)", line)
        if not k:
            continue
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        use = {"registers": int(regs.group(1)) if regs else None,
               "spill_bytes": int(spill.group(1)) if spill else None}
        if k.group(2):
            out.setdefault(FLASH_MODES[int(k.group(6))], {})[
                f"c{k.group(2)}_nh{k.group(3)}_ws{k.group(4)}_ows{k.group(5)}"
                + ("_planted" if k.group(7) == "1" else "")] = use
        elif k.group(8):
            kern = "strip_hab_block" if k.group(12) == "1" else \
                "fused_hab_block"
            out.setdefault(kern, {})[
                f"c{k.group(8)}_nh{k.group(9)}_n{k.group(10)}_mlp"
                f"{k.group(11)}"] = use
        else:
            out["copy_kernel"] = use
    spilled = [n for n, u in [*out.get("oca_kernel", {}).items(),
                              ("copy_kernel", out.get("copy_kernel", {}))]
               if u.get("spill_bytes")]
    if spilled:
        raise AssertionError(f"kernel 9 or 19 spills: {spilled} ({out})")
    return out


# Kernel 7's cab_tc_kernel instances in nvcc's report (main fills it):
# registers and spills by conv1's fragments (hidden / 8) and tile rows.
CAB_PTXAS: dict = {}


def cab_ptxas(report: str) -> dict:
    """Kernel 7's tensor-core instances: registers and spills; those of
    the deploy path's hidden widths (32, 40: 4 and 5 fragments) may not
    spill."""
    out: dict = {}
    lines = report.splitlines()
    for i, line in enumerate(lines):
        k = re.search(r"Compiling entry function '\S*?cab_tc_kernelILi(\d+)"
                      r"ELi(\d+)E", line)
        if not k:
            continue
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        out[f"nf{k.group(2)}_th{k.group(1)}"] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": int(spill.group(1)) if spill else None}
    spilled = [n for n, u in out.items()
               if n.startswith(("nf4_", "nf5_")) and u["spill_bytes"]]
    if spilled:
        raise AssertionError(f"kernel 7 spills: {spilled} ({out})")
    return out


def attn_case(cg: torch.Generator, case: str, nb: int):
    """Kernel 10's f32 inputs at the path's layout: q, k, v N(0, 1.5^2),
    so the logits spread over several units (printed), self-attention
    as the split of one packed [nb, 64, 3C] projection, cross (m 144) as
    a contiguous q beside the split of a gathered [nb, 144, 2C] kv; an
    N(0, 1) bias, the cross one gathered from a rel-pos table as the
    OCAB's; Swin region ids of the path's 576^2 map for 'shifted'."""
    from superresolution_tpu_torch.models.hat_lite import (
        relative_position_index_oca, shift_region_ids)

    def randn(*shape):
        return torch.randn(*shape, generator=cg, device="cuda") * 1.5

    ids = None
    if case == "cross":
        q = randn(nb, 64, 96)
        k, v = randn(nb, 144, 192).split(96, -1)
        idx = torch.as_tensor(relative_position_index_oca(8, 12),
                              device="cuda").long().reshape(-1)
        table = torch.randn(19 * 19, 6, generator=cg, device="cuda")
        bias = table[idx].reshape(64, 144, 6).permute(2, 0, 1).contiguous()
    else:
        q, k, v = randn(nb, 64, 288).split(96, -1)
        bias = torch.randn(6, 64, 64, generator=cg, device="cuda")
        if case == "shifted":
            side = 2 * (UP_TILE + 2 * UP_HALO)
            ids = torch.as_tensor(shift_region_ids(side, side, 8, 4),
                                  device="cuda")
    return q, k, v, bias, ids


def logit_spread(q, k, bias) -> dict:
    """Mean (max - min) and std of the first 256 windows' logits."""
    qh = q[:256].float().reshape(-1, 64, 6, 16).transpose(1, 2)
    kh = k[:256].float().reshape(qh.shape[0], -1, 6, 16).transpose(1, 2)
    lg = qh @ kh.transpose(-1, -2) * 0.25 + bias.float()
    return {"logit_range": float((lg.amax(-1) - lg.amin(-1)).mean()),
            "logit_std": float(lg.std())}


def check_attn(q, k, v, bias, ids, tag: str, tol: float) -> dict:
    """Kernel 10 on windows against its plain version; a bf16 launch must
    take the tensor cores, an f32 one the CUDA-core form."""
    from superresolution_tpu_torch.ops import window_attention as wa

    op = wa.flash_window_attention
    before, tc = op.launches, op.tc_launches
    got = op(q, k, v, bias, 6, ids)
    want_tc = tc + (q.dtype == torch.bfloat16)
    if op.launches != before + 1 or op.tc_launches != want_tc:
        raise AssertionError(f"{tag}: the launch was not counted on its "
                             "body")
    ref = wa.reference_window_attention(q, k, v, bias, 6, ids)
    return compare(f"flash_window_attention/{tag}", got, ref, tol)


def _planted_attn(fault: str):
    """A faulty replacement for kernel 10's tensor-core launch helper."""
    from superresolution_tpu_torch.ops import _build

    real = _build.window_attention_tc

    def planted(q, k, v, frags, ids, nh, scale, out):
        if fault == "scale_1_over_sqrt_C":
            scale = q.shape[-1] ** -0.5
        else:  # ids_b_div_nw: window b reads region_ids[b // nW_img]
            rows = torch.arange(q.shape[0], device=q.device) // ids.shape[0]
            ids = ids[rows].contiguous()
        real(q, k, v, frags, ids, nh, scale, out)
    return planted


def check_attn_kernel(cg: torch.Generator) -> dict:
    """Phase 12: kernel 10 against its plain version at the path's shapes
    (41,472 windows: 8 tiles of 288^2 at stage 2's 576^2), self
    unshifted, self shifted (region ids) and cross (m 144): in f32 to
    CHIPEQ's bars, in bf16 to 0.02; four planted faults; gradients
    through the autograd op against plain autograd; times."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import window_attention as wa

    bf = torch.bfloat16
    nb = UP_BATCH * ((2 * (UP_TILE + 2 * UP_HALO)) // 8) ** 2
    worst = {"f32": None, "bf16": None}
    times = {}
    for case in ("unshifted", "shifted", "cross"):
        q, k, v, bias, ids = attn_case(cg, case, nb)
        emit({"check": f"flash_window_attention/{case}/inputs", "nb": nb,
              "m": k.shape[1], **logit_spread(q, k, bias)})
        tol = TOL_ATTN_CROSS if case == "cross" else TOL_ATTN
        e32 = check_attn(q, k, v, bias, ids, f"{case}/f32", tol)
        qb, kb, vb = (t.to(bf) for t in (q, k, v))
        if case != "cross":  # keep the packed layout in bf16 too
            qb, kb, vb = torch.cat([q, k, v], -1).to(bf).split(96, -1)
        del q, k, v
        torch.cuda.empty_cache()
        e16 = check_attn(qb, kb, vb, bias, ids, f"{case}/bf16",
                         TOL_ATTN_BF16)
        for key, e in (("f32", e32), ("bf16", e16)):
            if worst[key] is None or e["max_rel_err"] > \
                    worst[key]["max_rel_err"]:
                worst[key] = e
        if case == "shifted":  # each planted fault must fail the check
            ref = wa.reference_window_attention(qb, kb, vb, bias, 6, ids)
            for fault, run in (
                    ("region_mask_dropped", lambda: wa.flash_window_attention(
                        qb, kb, vb, bias, 6, None)),
                    ("bias_dropped", lambda: wa.flash_window_attention(
                        qb, kb, vb, torch.zeros_like(bias), 6, ids))):
                expect_caught(fault, lambda: compare(
                    f"planted/{fault}", run(), ref, TOL_ATTN_BF16))
            for fault in ("scale_1_over_sqrt_C", "ids_b_div_nw"):
                real = _build.window_attention_tc
                _build.window_attention_tc = _planted_attn(fault)
                try:
                    expect_caught(fault, lambda: compare(
                        f"planted/{fault}", wa.flash_window_attention(
                            qb, kb, vb, bias, 6, ids), ref, TOL_ATTN_BF16))
                finally:
                    _build.window_attention_tc = real
            del ref
        m = kb.shape[1]
        n_img = nb // UP_BATCH
        if ids is None:
            mask = bias.to(bf)
        else:
            mask = (bias[None] + wa.region_mask(ids)[:, None]).to(bf)
        sq, sk, sv = (t.reshape(UP_BATCH, n_img, t.shape[1], 6, 16)
                      .transpose(2, 3) for t in (qb, kb, vb))
        flops = 4 * nb * 6 * 64 * m * 16
        nbytes = (2 * 64 + 2 * m) * 96 * 2 * nb + bias.numel() * 4 + (
            0 if ids is None else ids.numel() * 4)
        b_ms, b_by = bound(flops, nbytes)
        times[case] = {
            "ms": time_ms(lambda: wa.flash_window_attention(
                qb, kb, vb, bias, 6, ids), 10),
            "plain_ms": time_ms(lambda: wa.reference_window_attention(
                qb, kb, vb, bias, 6, ids), 5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask), 5),
            "bound_ms": b_ms, "bound_by": b_by, "m": m}
        emit({"phase": "kernel_time", "name": "flash_window_attention",
              "case": case, **times[case]})
        old_kernel("flash_window_attention", K10_OLD, list(qb.shape),
                   K10_OLD_MS[case], "10", case=case)
        del qb, kb, vb, sq, sk, sv, mask
        torch.cuda.empty_cache()

    # gradients: the op's backward is autograd of the plain form
    for case in ("shifted", "cross"):
        q, k, v, bias, ids = attn_case(cg, case, nb // UP_BATCH)
        g = torch.randn(q.shape, generator=cg, device="cuda")
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        got = torch.autograd.grad(
            wa.flash_window_attention(*leaves, 6, ids), leaves, g)
        plain = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        ref = torch.autograd.grad(
            wa.reference_window_attention(*plain, 6, ids), plain, g)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
            compare(f"flash_window_attention/grad/{case}/{name}", a, b,
                    TOL_ATTN_GRAD)

    times["map"] = check_map_attention(cg)
    times["widths"] = check_attn_widths(cg)
    main = times["unshifted"]
    return {"flash_window_attention": {
        "name": "flash_window_attention", "route": "cuda",
        "source": ATTN_TC_SRC,
        "sources": [ATTN_TC_SRC, *ATTN_WIDTH_SRCS, FLASH_SRC, ENGINE_SRC,
                    ATTN_SRC],
        "replaces": "superresolution_tpu/ops/pallas_attn.py:201",
        "shape": [nb, 64, 96], "max_abs_err": worst["bf16"]["max_abs_err"],
        "max_rel_err": worst["bf16"]["max_rel_err"], "tol": TOL_ATTN_BF16,
        "f32_max_rel_err": worst["f32"]["max_rel_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "ptxas": {k: ATTN_COPY_PTXAS.get(k) for k in FLASH_MODES[1:]},
        "cases": times}}


MAP_FAULTS = ("PLANT_ATTN_NO_MASK", "PLANT_ATTN_CLAMP",
              "PLANT_ATTN_SKIP_LAST")


def check_map_attention(cg: torch.Generator) -> dict:
    """Phase 12b: kernel 10's map form (flash_map_attention: q, k, v read
    from the qkv map [8, 576, 576, 288], the upscale path's stage 2, with
    the shift as addressing) at shift 0 and 4 against its plain version
    (roll, partition, attention with f32 logits, merge, roll back): bf16
    within 0.02, f32 (partition around the CUDA-core form) within 1e-4;
    its three planted faults (the mask dropped, the shifted address
    clamped, the last key tile skipped) caught at 3x the bar; the shift-4
    call timed beside the plain version and SDPA on the partitioned
    windows (the first form's chain printed from K10_OLD_MS). Returns the
    times."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import window_attention as wa

    bf = torch.bfloat16
    side = 2 * (UP_TILE + 2 * UP_HALO)
    qkv = (torch.randn(UP_BATCH, side, side, 288, generator=cg,
                       device="cuda") * 1.5).to(bf)
    bias = torch.randn(6, 64, 64, generator=cg, device="cuda")
    op = wa.flash_map_attention
    for shift in (0, 4):
        before = (op.launches, wa.flash_window_attention.tc_launches)
        got = op(qkv, bias, 6, 8, shift)
        if (op.launches, wa.flash_window_attention.tc_launches) != (
                before[0] + 1, before[1] + 1):
            raise AssertionError("flash_map_attention: the launch was not "
                                 "counted on the tensor cores")
        ref = wa.map_attention_reference(qkv, bias, 6, 8, shift)
        e16 = compare(f"flash_map_attention/shift{shift}/bf16", got, ref,
                      TOL_ATTN_BF16)
        del got
        small = qkv[:1, :288, :288].float().contiguous()
        compare(f"flash_map_attention/shift{shift}/f32",
                op(small, bias, 6, 8, shift),
                wa.map_attention_reference(small, bias, 6, 8, shift),
                TOL_ATTN)
    frags = wa.bias_fragments(bias, 0.25)
    for fault in MAP_FAULTS:
        out = torch.empty(ref.shape, dtype=bf, device="cuda")
        _build.map_attention(qkv, frags, 6, 8, 4, out,
                             plant=getattr(_build, fault))
        expect_margin(f"flash_map_attention/{fault}", out, ref,
                      TOL_ATTN_BF16)
    del out
    nb = UP_BATCH * (side // 8) ** 2
    ids = torch.as_tensor(wa.shift_region_ids(side, side, 8, 4),
                          device="cuda")
    rolled = torch.roll(qkv, (-4, -4), dims=(1, 2))
    sq, sk, sv = (t.reshape(UP_BATCH, nb // UP_BATCH, 64, 6, 16)
                  .transpose(2, 3) for t in
                  wa.window_partition(rolled, 8).split(96, -1))
    mask = (bias[None] + wa.region_mask(ids)[:, None]).to(bf)
    b_ms, b_by = bound(4 * nb * 6 * 64 * 64 * 16,
                       qkv.numel() * 2 + nb * 64 * 96 * 2 + bias.numel() * 4)
    times = {"ms": time_ms(lambda: op(qkv, bias, 6, 8, 4), 10),
             "plain_ms": time_ms(lambda: wa.map_attention_reference(
                 qkv, bias, 6, 8, 4), 3),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 sq, sk, sv, attn_mask=mask), 5),
             "bound_ms": b_ms, "bound_by": b_by, "nb": nb,
             "max_rel_err": e16["max_rel_err"]}
    emit({"phase": "kernel_time", "name": "flash_map_attention",
          "case": "upscale_shift4", **times})
    old_kernel("flash_map_attention", K10_OLD + ", between roll, "
               "window_partition, window_merge and roll back",
               list(qkv.shape), K10_OLD_MS["map"], "10", case="map")
    del qkv, rolled, sq, sk, sv, mask, ref
    torch.cuda.empty_cache()
    return times


# kernel 10's widths beside the model's (C, heads) (96, 6), (128, 8) and
# (120, 6): head dim 16 at 1-5 and 7 heads, head dim 20 at 1-5
# (attn_tc_widths16.cu, attn_tc_widths20.cu)
ATTN_WIDTHS = ((16, 1), (32, 2), (48, 3), (64, 4), (80, 5), (112, 7),
               (20, 1), (40, 2), (60, 3), (80, 4), (100, 5))


def check_attn_widths(cg: torch.Generator) -> dict:
    """Phase 12c: kernel 10 in bf16 at every width of ATTN_WIDTHS, on
    windows at every (n, m) of ATTN_NM (self-attention shifted, with the
    region ids of a map of 16 windows; cross on the split of a packed kv)
    and on the map at ws 8 and 16 (shift ws/2; the map also at (128, 8)),
    each against its plain version within 0.02 and each launch counted on
    the tensor cores (one line a width: its worst error); then HATLite
    (depth 2, ws 8) at (C, heads) (64, 4) and (60, 3) under flash_attn
    against the same model on plain attention with f32 logits within
    0.03, kernel 10 exactly 3 launches (2 map form, 1 OCAB), all on the
    tensor cores; (64, 4) at n 64 timed beside its bound. Returns the
    time."""
    from superresolution_tpu_torch.models.hat_lite import HATLite
    from superresolution_tpu_torch.ops import window_attention as wa

    bf = torch.bfloat16
    op, mop = wa.flash_window_attention, wa.flash_map_attention
    gen = torch.Generator().manual_seed(SEED + 12)  # the HATLites' weights

    def randn(*shape):
        return (torch.randn(*shape, generator=cg, device="cuda")
                * 1.5).to(bf)

    def counted(fn, maps: int):
        before = (op.launches, op.tc_launches, mop.launches)
        out = fn()
        if (op.launches, op.tc_launches, mop.launches) != (
                before[0] + 1, before[1] + 1, before[2] + maps):
            raise AssertionError("kernel 10: a width's launch was not "
                                 "counted on the tensor cores")
        return out

    for c, nh in (*ATTN_WIDTHS, (128, 8)):
        worst, n_checks = 0.0, 0
        for n, m in wa.ATTN_NM if (c, nh) != (128, 8) else ():
            ws = int(n ** 0.5)
            ids = None
            if m == n:
                q, k, v = randn(16, n, 3 * c).split(c, -1)
                ids = torch.as_tensor(wa.shift_region_ids(
                    4 * ws, 4 * ws, ws, ws // 2), device="cuda")
            else:
                q = randn(16, n, c)
                k, v = randn(16, m, 2 * c).split(c, -1)
            bias = torch.randn(nh, n, m, generator=cg, device="cuda")
            got = counted(lambda: op(q, k, v, bias, nh, ids), 0)
            ref = wa.reference_window_attention(q, k, v, bias, nh, ids)
            worst = max(worst, rel_err(got, ref))
            n_checks += 1
        for ws in (8, 16):
            qkv = randn(2, 4 * ws, 4 * ws, 3 * c)
            bias = torch.randn(nh, ws * ws, ws * ws, generator=cg,
                               device="cuda")
            got = counted(lambda: mop(qkv, bias, nh, ws, ws // 2), 1)
            ref = wa.map_attention_reference(qkv, bias, nh, ws, ws // 2)
            worst = max(worst, rel_err(got, ref))
            n_checks += 1
        emit({"check": f"flash_window_attention/width_c{c}_nh{nh}",
              "checks": n_checks, "max_rel_err": worst,
              "tol": TOL_ATTN_BF16})
        if worst > TOL_ATTN_BF16:
            raise AssertionError(f"kernel 10 at C {c}, {nh} heads: "
                                 f"relative error {worst}")

    for c, nh in ((64, 4), (60, 3)):
        hat = HATLite(scale=2, in_channels=1, out_channels=1, embed_dim=c,
                      depths=(2,), num_heads=(nh,), window_size=8,
                      attn_f32=False, flash_attn=True,
                      generator=gen).to(bf).eval()
        with torch.no_grad():
            for name, p in hat.named_parameters():
                if name.endswith(".bias"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        plain = copy.deepcopy(hat)
        set_attention(plain, False, True)
        x = torch.rand((1, 64, 64, 1), generator=gen).to("cuda", bf)
        with torch.inference_mode():
            before = (op.launches, op.tc_launches, mop.launches)
            got = hat(x)
            counts = (op.launches - before[0], op.tc_launches - before[1],
                      mop.launches - before[2])
            if counts != (3, 3, 2):
                raise AssertionError(f"HATLite at C {c}: kernel 10 "
                                     f"launches {counts}, expected (3, 3, 2)")
            compare(f"hat_lite_flash/c{c}_nh{nh}", got, plain(x), TOL_PATH)
        del hat, plain

    nb = UP_BATCH * ((2 * (UP_TILE + 2 * UP_HALO)) // 8) ** 2 // 4
    q, k, v = randn(nb, 64, 192).split(64, -1)
    bias = torch.randn(4, 64, 64, generator=cg, device="cuda")
    b_ms, b_by = bound(4 * nb * 4 * 64 * 64 * 16,
                       4 * 64 * 64 * 2 * nb + bias.numel() * 4)
    times = {"ms": time_ms(lambda: op(q, k, v, bias, 4), 10),
             "plain_ms": time_ms(lambda: wa.reference_window_attention(
                 q, k, v, bias, 4), 5),
             "bound_ms": b_ms, "bound_by": b_by, "nb": nb}
    emit({"phase": "kernel_time", "name": "flash_window_attention",
          "case": "c64_nh4_n64", **times})
    return times


def set_attention(model, flash: bool, attn_f32: bool) -> None:
    """Switch every window attention and OCAB of `model` between kernel
    10 and the plain form (f32 or compute-type logits)."""
    from superresolution_tpu_torch.models.hat_lite import (
        OCAB, WindowAttention)

    for mod in model.modules():
        if isinstance(mod, (WindowAttention, OCAB)):
            mod.flash, mod.attn_f32 = flash, attn_f32


def fit_output(model, gen: torch.Generator, conv=None,
               channels: int = 1) -> None:
    """Rescale the model's last conv (stage 2's conv_last unless `conv`
    is given) so that the random model's output has mean 0.5 and std 0.2
    on a probe tile. A trained model's output lies in [0, 1]; this
    random one's spreads over hundreds, so after api.upscale's clip
    almost every pixel is 0 or 1, and one bf16 step before the clip flips
    a pixel by 1 (the first run of this phase). The smoothing after
    conv_last is a normalized blur, so the frame moves by the same affine
    map."""
    side = UP_TILE + 2 * UP_HALO
    x = torch.rand((1, side, side, channels), generator=gen).to(
        "cuda", torch.bfloat16)
    with torch.inference_mode():
        y = model(x).float()
    m, sd = float(y.mean()), float(y.std())
    a = 0.2 / sd
    conv = model.stage2.conv_last if conv is None else conv
    with torch.no_grad():
        conv.weight.mul_(a)
        conv.bias.copy_(conv.bias.float() * a + 0.5 - a * m)
    emit({"check": "upscale/output_fit", "raw_mean": m, "raw_std": sd,
          "conv_last_scale": a})


# the device split's groups, by the first substring of the kernel's name
# that matches (the rest are "other"); PyTorch's elementwise_kernel<128, 4,
# ...> is its TensorIterator loop for operands that are not contiguous
# (the NCHW views of the NHWC maps), vectorized_elementwise_kernel the one
# for contiguous operands
SPLIT_GROUPS = (("kernel 10", ("flash_kernel", "attn_kernel")),
                ("copies, rolls, concatenations", ("copy", "roll",
                                                   "CatArray")),
                ("LayerNorm", ("layer_norm",)),
                ("convs", ("fprop", "dgrad", "implicit", "winograd",
                           "conv")),
                ("linears (GEMM)", ("nvjet", "gemm", "cutlass", "s16816")),
                ("strided elementwise", ("elementwise_kernel<128, 4",)),
                ("contiguous elementwise", ("vectorized_elementwise",)))


def device_split(prof) -> dict:
    """Device ms by kernel name (the 12 largest) and by SPLIT_GROUPS, with
    each group's share, from a torch.profiler run."""
    on_card = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in on_card) / 1e3
    groups: dict = {}
    for e in on_card:
        name = next((g for g, keys in SPLIT_GROUPS
                     if any(k in e.key for k in keys)), "other")
        groups[name] = groups.get(name, 0.0) + e.self_device_time_total / 1e3
    return {"device_ms": total or None,
            "by_group": {g: {"ms": ms, "share": ms / total if total else None}
                         for g, ms in sorted(groups.items(),
                                             key=lambda kv: -kv[1])},
            "top_device_kernels": [
                {"kernel": e.key[:240], "ms": e.self_device_time_total / 1e3,
                 "count": e.count} for e in on_card[:12]]}


def upscale_path(gen: torch.Generator, card: str) -> dict:
    """Phase 13: a FRAME^2 frame through api.upscale (on-device tiler,
    256 tiles + halo 16, batches of 8) over the bench_hybrid model with
    flash attention and no output resize, launches counted; against the
    same call on plain attention with f32 logits, the host tiler, and
    times; the model's last conv fitted first (fit_output). Returns the
    launches."""
    from superresolution_tpu_torch import api

    model = hybrid_model(gen, output_size=None, attn_f32=False,
                         flash_attn=True)
    fit_output(model, gen)
    params = model.state_dict()
    frame = torch.rand((FRAME, FRAME, 1), generator=gen).numpy()
    kw = dict(model=model, params=params, tile=UP_TILE, halo=UP_HALO,
              batch=UP_BATCH)
    side = 4 * FRAME
    ops = zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y = api.upscale(frame, 4, on_device=True, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: op.launches for k, op in ops.items()}
    batches = -(-(FRAME // UP_TILE) ** 2 // UP_BATCH)
    n_attn = sum(model.stage2.depths) + len(model.stage2.depths)
    check_launches("upscale", launches, {
        **{k: 0 for k in ops}, "flash_window_attention": batches * n_attn})
    expect_attn_bodies("upscale", batches * sum(model.stage2.depths))
    if tuple(y.shape) != (side, side, 1):
        raise AssertionError(f"upscale output shape {tuple(y.shape)}")
    if not bool(torch.isfinite(y).all()) or float(y.min()) < 0 \
            or float(y.max()) > 1:
        raise AssertionError("upscale: output not finite in [0, 1]")
    emit({"phase": "upscale_path", "output_shape": list(y.shape),
          "first_run_s": first_s, "launches_per_frame": launches,
          "batches": batches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    # the plain frame, timed once (its first run, as the kernel path's
    # first_run_s is), with its peak memory
    plain = copy.deepcopy(model)
    set_attention(plain, False, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y_plain = api.upscale(frame, 4, on_device=True, **dict(kw, model=plain))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    compare("upscale/frame_vs_plain_f32_logits", y, y_plain, TOL_PATH)
    y_host = torch.from_numpy(api.upscale(frame, 4, on_device=False,
                                          blend="crop", **kw))
    d_host = float((y_host - y.cpu()).abs().max())
    emit({"check": "upscale/host_tiler_vs_on_device", "max_abs_diff": d_host,
          "tol": TOL_TILERS})
    if d_host > TOL_TILERS:
        raise AssertionError(f"host tiler {d_host} from the on-device one")
    y_hann = torch.from_numpy(api.upscale(frame, 4, on_device=False,
                                          blend="hann", **kw))
    emit({"check": "upscale/hann_vs_crop (printed, not held)",
          "max_abs_diff": float((y_hann - y_host).abs().max()),
          "mean_abs_diff": float((y_hann - y_host).abs().mean())})
    del y_host, y_hann, y, y_plain

    def host_s(fn, runs=2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / runs

    del plain
    torch.cuda.reset_peak_memory_stats()
    frame_s = host_s(lambda: api.upscale(frame, 4, on_device=True, **kw))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # device time of one frame by kernel, from the profiler; beside it the
    # frame with kernel 10's first form and the HAB on windows (printed
    # from K10_OLD_FRAME, not re-run)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.upscale(frame, 4, on_device=True, **kw)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    split = {"profiled_frame_s": prof_s, **device_split(prof)}
    emit({"phase": "upscale_device_split", "form": "map_form", **split})
    emit({"phase": "upscale_device_split", "form": "first_form",
          **K10_OLD_FRAME, "from": "PERF.md section 5, not re-run"})
    device_ms = split["device_ms"]
    emit({"phase": "upscale_times", "card": card, "frame_s": frame_s,
          "mp_per_s": FRAME ** 2 / 1e6 / frame_s, "plain_frame_s": plain_s,
          "plain_mp_per_s": FRAME ** 2 / 1e6 / plain_s,
          "peak_mem_gib": peak, "plain_peak_mem_gib": plain_peak,
          "profiled_frame_s": prof_s,
          # None when the profiler saw no device time
          "device_ms_per_frame": device_ms,
          "device_busy_share": device_ms / (prof_s * 1e3) if device_ms
          else None})
    return launches


def finish(stage2, z):
    """Stage 2 and the smoothing after it, as HybridSR runs them."""
    from superresolution_tpu_torch.ops.blur import anti_checkerboard

    return anti_checkerboard(anti_checkerboard(stage2(z), "balanced"),
                             "light")


def no_gather_path(gen: torch.Generator) -> None:
    """Phase 14: bench_hybrid's frame through fused_hybrid_model with
    SRTPU_GATHER_OCA=0 (each OCAB on kernel 10, none on kernel 9), then
    an odd-overlap HATLite (ows 11) through make_fused_hat; both against
    their plain models on the same bf16 weights."""
    from superresolution_tpu_torch.infer.fused_hat import (
        fused_hybrid_model, make_fused_hat)
    from superresolution_tpu_torch.infer.fused_trunk import fused_rrdb_model
    from superresolution_tpu_torch.models.hat_lite import HATLite
    from superresolution_tpu_torch.ops.blur import anti_checkerboard

    bf = torch.bfloat16
    model = hybrid_model(gen)
    params = model.state_dict()
    x = torch.rand((1, HYBRID_IN, HYBRID_IN, 1), generator=gen).to("cuda", bf)
    n_hab = sum(model.stage2.depths)
    os.environ["SRTPU_GATHER_OCA"] = "0"
    try:
        with torch.inference_mode():
            fused = fused_hybrid_model(params, model)
            ops = zero_counts()
            y = fused(x)
            torch.cuda.synchronize()
            check_launches("no_gather", {k: op.launches
                                         for k, op in ops.items()}, {
                **{k: 0 for k in ops}, "fused_dense_block": 69 * 5,
                "fused_cab_convs": n_hab, "fused_hab_block": n_hab,
                "flash_window_attention": len(model.stage2.depths)})
            expect_attn_bodies("no_gather", 0)
            sub = {k: {n[len(k) + 1:]: v for n, v in params.items()
                       if n.startswith(k + ".")} for k in ("stage1", "stage2")}
            s2 = make_fused_hat(sub["stage2"], model.stage2)
            z = anti_checkerboard(
                fused_rrdb_model(sub["stage1"], model.stage1)(x), "balanced")
            compare("no_gather/stage2_and_after", finish(s2, z),
                    finish(model.stage2, z), TOL_PATH,
                    frame_rel_err_end_to_end=rel_err(y, model(x)))
    finally:
        del os.environ["SRTPU_GATHER_OCA"]
    del model, params, fused, s2
    torch.cuda.empty_cache()

    hat = HATLite(scale=2, in_channels=1, out_channels=1, embed_dim=96,
                  depths=(2,), num_heads=(6,), window_size=8,
                  overlap_ratio=0.375, generator=gen).to(bf).eval()
    with torch.no_grad():
        for name, p in hat.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    x = torch.rand((1, HYBRID_IN, HYBRID_IN, 1), generator=gen).to("cuda", bf)
    with torch.inference_mode():
        apply = make_fused_hat(hat.state_dict(), hat)
        ops = zero_counts()
        got = apply(x)
        check_launches("odd_ocab", {k: op.launches for k, op in ops.items()},
                       {**{k: 0 for k in ops}, "fused_cab_convs": 2,
                        "fused_hab_block": 2, "flash_window_attention": 1})
        compare("odd_ocab/hat_ows11", got, hat(x), TOL_PATH,
                ows=hat.layers[0].overlap_attn.ows)


def quality_anchor() -> dict:
    """Phase 15: the committed checkpoint (assets/quality/port, exported
    from the JAX one) through fused_rrdb_model (B1-B3) in bf16 on 8
    synthetic 128^2 images degraded x1/4 (bench.py's quality stage):
    PSNR against the reference's figure, bicubic PSNR against its own."""
    from superresolution_tpu_torch.data.dataset import SyntheticHRDataset
    from superresolution_tpu_torch.infer.fused_trunk import fused_rrdb_model
    from superresolution_tpu_torch.metrics.psnr_ssim import psnr, ssim
    from superresolution_tpu_torch.models.factory import get_model
    from superresolution_tpu_torch.ops.degradation import degrade_bicubic
    from superresolution_tpu_torch.ops.resize import resize_bicubic
    from superresolution_tpu_torch.train.checkpoint import (
        load_params_for_inference)

    sd, cfg = load_params_for_inference(ANCHOR_DIR, with_config=True)
    model = get_model(cfg["name"], scale=cfg["scale"],
                      in_channels=cfg["in_channels"],
                      out_channels=cfg["out_channels"], **cfg["kwargs"])
    model.load_state_dict(sd, strict=True)
    model = model.to(torch.bfloat16).eval()
    scale = cfg["scale"]
    ds = SyntheticHRDataset(8, 128, cfg["out_channels"], seed=2)
    hr = torch.stack([torch.from_numpy(ds[i]["hr"])
                      for i in range(len(ds))]).cuda()
    lr = degrade_bicubic(hr, scale)
    with torch.inference_mode():
        deploy = fused_rrdb_model(model.state_dict(), model)
        ops = zero_counts()
        sr = deploy(lr.to(torch.bfloat16)).float().clamp(0, 1)
        note_unrouted("quality_anchor",
                      {k: op.launches for k, op in ops.items()})
        launches = {k: op.launches for k, op in ops.items() if op.launches}
        up = resize_bicubic(lr, (hr.shape[1], hr.shape[2])).clamp(0, 1)
        p, s = float(psnr(sr, hr).mean()), float(ssim(sr, hr).mean())
        pb = float(psnr(up, hr).mean())
    res = {"check": "quality_anchor", "psnr": p, "ssim": s,
           "bicubic_psnr": pb, "delta_vs_bicubic": p - pb,
           "reference_psnr": ANCHOR_PSNR, "reference_ssim": 0.6778,
           "reference_bicubic_psnr": ANCHOR_BICUBIC,
           "jax_cpu_f32": {"psnr": 25.6021, "ssim": 0.6848},
           "jax_cpu_bf16": {"psnr": 25.5891, "ssim": 0.6841},
           "tol_psnr": TOL_ANCHOR, "tol_bicubic": TOL_ANCHOR_BICUBIC,
           "launches": launches}
    emit(res)
    if launches.get("fused_dense_block", 0) != 5 * 3 * model.num_blocks \
            or not launches.get("up2_hr") or not launches.get(
                "conv_last_phase"):
        raise AssertionError(f"quality anchor launches {launches}")
    if abs(p - ANCHOR_PSNR) > TOL_ANCHOR:
        raise AssertionError(f"anchor PSNR {p} vs {ANCHOR_PSNR}")
    if abs(pb - ANCHOR_BICUBIC) > TOL_ANCHOR_BICUBIC:
        raise AssertionError(f"bicubic PSNR {pb} vs {ANCHOR_BICUBIC}")
    return res


# ---- 16-21: kernels 4-6 behind the ESRGAN trunk's levers; the port's
# ---- repaired faults: kernels 8-10 at the reference's other geometries,
# ---- the hybrid_astro_h200 class, the prebound models in the tilers ----

TRUNK_OPS = ("fused_dense_block_prologue", "fused_dense_block_epilogue",
             "fused_rrdb")
# Faults planted in kernels 4-6 through their launch helpers' `plant`
# (ops/_build.py): each check must fail on every one.
CHAIN_FAULTS = ("residual_dropped", "first_stages_swapped")
# Faults planted in kernel 6's tensor-core launch alone (_build's bits):
# no grid barrier between its stages. Checked on fresh inputs and
# NaN-filled scratch, so a read of a tile not yet written shows.
RRDB_TC_FAULTS = {"stage_barrier_skipped": "PLANT_NO_BARRIER"}
# Faults planted in kernels 4 and 5's tensor-core launch sequences
# (ops/dense_trunk.prologue_launches / epilogue_launches, _build's bits):
# the two CHAIN_FAULTS (kernel 4: B1's x + 0.2 v residual dropped; kernel
# 5: trunk_conv's + head dropped; the first two launches swapped) and
# conv_first's own, its halo read from the border pixel and not zero.
# Checked by 3x the bar on fresh inputs and NaN-filled scratch.
END_FOLD_FAULTS = {
    "fused_dense_block_prologue": {
        "residual_dropped": "PLANT_NO_RESIDUAL",
        "first_stages_swapped": "PLANT_SWAP_STAGES",
        "halo_clamped": "PLANT_HALO_CLAMPED"},
    "fused_dense_block_epilogue": {
        "residual_dropped": "PLANT_NO_RESIDUAL",
        "first_stages_swapped": "PLANT_SWAP_STAGES"}}
# One call of kernel 4 or 5 on the tensor-core route, by body: kernel 4
# conv_first on the conv engine's direct body and B1's five launches on
# its tensor cores, kernel 5 B1's five and trunk_conv on the tensor cores.
END_FOLD_BODIES = {
    "fused_dense_block_prologue": {"launches": 1, "tc_launches": 5,
                                   "direct_launches": 1},
    "fused_dense_block_epilogue": {"launches": 1, "tc_launches": 6,
                                   "direct_launches": 0}}


def by_body(op) -> dict:
    """A counted op's launches (calls, for kernels 4 and 5) and its
    launches by body."""
    return {"launches": op.launches, "tc_launches": op.tc_launches,
            "direct_launches": op.direct_launches}


def end_conv_weights(gen: torch.Generator, cin: int, cout: int = 64):
    """conv_first / trunk_conv weights for kernels 4 and 5's checks: MSRA
    x 2, as B1's check weights, and N(0, 0.1) biases."""
    from superresolution_tpu_torch.ops import dense_trunk as dt

    k = torch.randn(3, 3, cin, cout, generator=gen) * 2 * (
        2 / (9 * cin)) ** 0.5
    return dt.dense_weights([k], [torch.randn(cout, generator=gen) * 0.1],
                            device="cuda")[0]


def trunk_cases(gen: torch.Generator, b: int, h: int, w: int, ws3, ends):
    """Kernels 4-6's inputs at one geometry and their calls: name ->
    (kernel call, plain call in f32 on the upcast inputs, (module, name)
    of the launch function that takes the kernel's `plant`)."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt

    def randn(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(
            "cuda", torch.bfloat16)

    head_w, trunk_w = ends
    x_raw = randn(b, h, w, 3, scale=0.5)
    x, res, head = (randn(b, h, w, 64, scale=s) for s in (0.2, 0.1, 0.05))
    return {
        "fused_dense_block_prologue": (
            lambda: dt.fused_dense_block_prologue(x_raw, head_w, ws3[0]),
            lambda: dt.fused_dense_block_prologue_reference(
                x_raw.float(), head_w, ws3[0]), (dt, "prologue_launches")),
        "fused_dense_block_epilogue": (
            lambda: dt.fused_dense_block_epilogue(x, ws3[2], res, trunk_w,
                                                  head),
            lambda: dt.fused_dense_block_epilogue_reference(
                x.float(), ws3[2], res.float(), trunk_w, head.float()),
            (dt, "epilogue_launches")),
        "fused_rrdb": (
            lambda: dt.fused_rrdb(x, *ws3),
            lambda: dt.fused_rrdb_reference(x.float(), *ws3),
            (_build, "rrdb_tc")),
    }, (x_raw, x, res, head)


def check_chain(name: str, kern, plain, tag: str) -> dict:
    """One of kernels 4-6 against its plain version in f32 within
    TOL_KERNEL (kernel 4 on both outputs), its call counted once and none
    of its launches on B1's counts."""
    from superresolution_tpu_torch.ops import dense_trunk as dt

    op, b1 = getattr(dt, name), dt.fused_dense_block
    before, b1_before = op.launches, by_body(b1)
    got, ref = kern(), plain()
    if op.launches != before + 1 or by_body(b1) != b1_before:
        raise AssertionError(f"{name}/{tag}: not one counted launch, or "
                             "counted on B1")
    if name == "fused_dense_block_prologue":
        compare(f"{name}/{tag}/head", got[1], ref[1], TOL_KERNEL)
        got, ref = got[0], ref[0]
    return compare(f"{name}/{tag}", got, ref, TOL_KERNEL)


def check_trunk_kernels(gen: torch.Generator, n_tiles: int) -> dict:
    """Phase 16: kernels 4, 5, 6 against their plain versions (f32 on the
    upcast bf16 inputs) within 0.02, at a CHIPEQ-sized geometry, a ragged
    one and the main path's shape, with B1's MSRA x 2 check weights; at
    the first each check must fail on both CHAIN_FAULTS, planted on fresh
    inputs (so stale scratch from a right run cannot hide them), and
    kernels 4 and 5 on END_FOLD_FAULTS by 3x the bar on NaN-filled
    scratch (check_end_fold_faults); timed at the latter beside the
    bound, the plain version and the default path for the same function
    (plain convs and B1 calls), kernels 4 and 5 also by body, with their
    launch outside B1 alone and conv_chain_kernel live
    (end_fold_times)."""
    import functools

    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt

    ws3 = [dense_check_weights(gen) for _ in range(3)]
    ends = (end_conv_weights(gen, 3), end_conv_weights(gen, 64))
    th, tw = TILE[0] + 2 * HALO, TILE[1] + 2 * HALO
    out = {}
    for geom, (b, h, w) in (("chipeq", (2, 48, 64)), ("ragged", (1, 37, 45)),
                            ("main", (n_tiles, th, tw))):
        cases, (x_raw, x, res, head) = trunk_cases(gen, b, h, w, ws3, ends)
        errs = {name: check_chain(name, kern, plain, geom)
                for name, (kern, plain, _) in cases.items()}
        if geom == "chipeq":
            for bit, fault in zip((_build.PLANT_NO_RESIDUAL,
                                   _build.PLANT_SWAP_STAGES), CHAIN_FAULTS):
                fresh, _ = trunk_cases(gen, b, h, w, ws3, ends)
                for name, (kern, plain, (mod, fn)) in fresh.items():
                    real = getattr(mod, fn)
                    setattr(mod, fn, functools.partial(real, plant=bit))
                    try:
                        expect_caught(f"{name}:{fault}", lambda: check_chain(
                            name, kern, plain, f"fault:{fault}"))
                    finally:
                        setattr(mod, fn, real)
            check_rrdb_tc_faults(gen, ws3, b, h, w)
            check_end_fold_faults(gen, ws3, ends, b, h, w)
        if geom != "main":
            continue
        del cases
        torch.cuda.empty_cache()
        px = b * h * w
        head_oihw = ends[0][0].permute(3, 2, 0, 1).contiguous()
        trunk_oihw = ends[1][0].permute(3, 2, 0, 1).contiguous()

        def nchw_conv(t, k, bias):
            return F.conv2d(t.permute(0, 3, 1, 2), k, bias.to(t.dtype),
                            padding=1).permute(0, 2, 3, 1).contiguous()

        def default_prologue():
            hd = nchw_conv(x_raw, head_oihw, ends[0][1])
            return dt.fused_dense_block(hd, ws3[0]), hd

        def default_epilogue():
            y = dt.fused_dense_block(x, ws3[2], residual=res)
            return nchw_conv(y, trunk_oihw, ends[1][1]) + head

        def default_rrdb():
            y = dt.fused_dense_block(dt.fused_dense_block(x, ws3[0]), ws3[1])
            return dt.fused_dense_block(y, ws3[2], residual=x)

        rows = {
            "fused_dense_block_prologue": (
                "superresolution_tpu/ops/pallas_dense_trunk.py:355",
                lambda: dt.fused_dense_block_prologue(x_raw, ends[0],
                                                      ws3[0]),
                lambda: dt.fused_dense_block_prologue_reference(
                    x_raw, ends[0], ws3[0]), default_prologue,
                2 * px * (B1_MACS + 9 * 3 * 64),
                px * (3 + 2 * 64) * 2 + 2 * (B1_MACS + 9 * 3 * 64), 5),
            "fused_dense_block_epilogue": (
                "superresolution_tpu/ops/pallas_dense_trunk.py:414",
                lambda: dt.fused_dense_block_epilogue(x, ws3[2], res,
                                                      ends[1], head),
                lambda: dt.fused_dense_block_epilogue_reference(
                    x, ws3[2], res, ends[1], head), default_epilogue,
                2 * px * (B1_MACS + 9 * 64 * 64),
                4 * px * 64 * 2 + 2 * (B1_MACS + 9 * 64 * 64), 5),
            "fused_rrdb": (
                "superresolution_tpu/ops/pallas_dense_trunk.py:485",
                lambda: dt.fused_rrdb(x, *ws3),
                lambda: dt.fused_rrdb_reference(x, *ws3), default_rrdb,
                2 * px * 3 * B1_MACS, 2 * px * 64 * 2 + 6 * B1_MACS, 3),
        }
        for name, (tpu, kern, plain, default, flops, nbytes, iters) \
                in rows.items():
            b_ms, b_by = bound(flops, nbytes)
            err = errs[name]
            out[name] = {
                "name": name, "route": "cuda", "source": SRC,
                "replaces": tpu, "shape": [b, h, w, 64],
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"], "tol": TOL_KERNEL,
                "ms": time_ms(kern, iters), "plain_ms": time_ms(plain, iters),
                "default_path_ms": time_ms(default, iters),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            if name == "fused_rrdb":  # on the tensor-core launch
                flat = [p for ws in ws3 for p in ws]
                scratch = (torch.empty((b, h, w, 128), dtype=x.dtype,
                                       device="cuda"),
                           torch.empty_like(x), torch.empty_like(x))
                out[name].update(
                    source=DENSE_SRC, sources=[DENSE_SRC, ENGINE_SRC],
                    three_b1_ms=out[name]["default_path_ms"],
                    parent_kernel_ms=time_ms(
                        lambda: _build.rrdb(x, flat, *scratch), 2),
                    parent_kernel="sr_kernels.cu conv_chain_kernel, 15 "
                                  "stages of f32 FFMA conv_tile")
                del scratch
            else:
                out[name].update(end_fold_times(name, kern, x_raw, x, res,
                                                head, ws3, ends))
            out[name]["ms_over_default_path"] = (
                out[name]["ms"] / out[name]["default_path_ms"])
            emit({"phase": "kernel_time", **out[name]})
    kernel, ms, row = OLD_KERNELS["fused_rrdb"]
    old_kernel("fused_rrdb", kernel, [b, h, w, 64], ms, row)
    return out


def end_fold_times(name: str, kern, x_raw, x, res, head, ws3,
                   ends) -> dict:
    """Kernel 4's or 5's own phase-16 fields at the main shape: its
    launches by body in one call (END_FOLD_BODIES, checked), its one
    engine launch outside B1 timed alone beside that launch's bound
    (kernel 4's conv_first on the direct body, kernel 5's trunk_conv with
    its + head), and conv_chain_kernel (the parent's body, now the
    off-route one) timed live through the retained launch helper."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt

    op = getattr(dt, name)
    zero = by_body(op)
    kern()
    bodies = {k: v - zero[k] for k, v in by_body(op).items()}
    if bodies != END_FOLD_BODIES[name]:
        raise AssertionError(f"{name}: launches by body {bodies} != "
                             f"{END_FOLD_BODIES[name]}")
    b, h, w, c = x.shape
    px = b * h * w
    ws = torch.empty((b, h, w, 128), dtype=x.dtype, device="cuda")
    feat, o = torch.empty_like(x), torch.empty_like(x)
    if name == "fused_dense_block_prologue":
        cin = x_raw.shape[-1]
        stage, macs = "conv_first", 9 * cin * c
        nbytes = px * (cin + c) * 2 + macs * 2

        def stage_fn():
            _build.first_conv(x_raw, *ends[0], feat)

        def parent():
            _build.dense_prologue(x_raw, ends[0], ws3[0], ws, o, feat)
    else:
        stage, macs = "trunk_conv", 9 * c * c
        nbytes = 3 * px * c * 2 + macs * 2

        def stage_fn():
            _build.dense_conv(x, None, 0, *ends[1], o, 0, add=head)

        def parent():
            _build.dense_epilogue(x, ws3[2], res, ends[1], head, ws, feat, o)
    s_ms = time_ms(stage_fn, 20)
    s_bound, s_by = bound(2 * px * macs, nbytes)
    fields = {
        "source": DENSE_SRC, "sources": [DENSE_SRC, ENGINE_SRC, SRC],
        "launches_by_body": bodies, f"{stage}_ms": s_ms,
        f"{stage}_bound_ms": s_bound, f"{stage}_bound_by": s_by,
        f"{stage}_share_of_bound": s_bound / s_ms,
        "parent_kernel_ms": time_ms(parent, 2),
        "parent_kernel": "sr_kernels.cu conv_chain_kernel, 6 stages of "
                         "f32 FFMA conv_tile"}
    if stage == "conv_first":
        fields["ptxas"] = PTXAS.get("DenseConv", {}).get("direct")
    return fields


def check_end_fold_faults(gen: torch.Generator, ws3, ends, b: int, h: int,
                          w: int) -> None:
    """Kernels 4 and 5's tensor-core launch sequences on fresh inputs with
    their scratch and outputs filled with NaN: within the bar clean, and
    each of END_FOLD_FAULTS missing it by 3x (kernel 4 on the worse of its
    two outputs)."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt

    def nan(c):
        return torch.full((b, h, w, c), float("nan"), dtype=torch.bfloat16,
                          device="cuda")

    def run(name: str, bit: int):
        x_raw = rand(gen, b, h, w, 3, scale=0.5, dtype=torch.bfloat16)
        x, res, head = (rand(gen, b, h, w, 64, scale=s, dtype=torch.bfloat16)
                        for s in (0.2, 0.1, 0.05))
        ws, out = nan(128), nan(64)
        if name == "fused_dense_block_prologue":
            hd = nan(64)
            dt.prologue_launches(x_raw, ends[0], ws3[0], ws, out, hd,
                                 plant=bit)
            ref = dt.fused_dense_block_prologue_reference(
                x_raw.float(), ends[0], ws3[0])
            pairs = [(out, ref[0]), (hd, ref[1])]
        else:
            dt.epilogue_launches(x, ws3[2], res, ends[1], head, ws, nan(64),
                                 out, plant=bit)
            pairs = [(out, dt.fused_dense_block_epilogue_reference(
                x.float(), ws3[2], res.float(), ends[1], head.float()))]

        def err(pair):
            ok = bool(torch.isfinite(pair[0].float()).all())
            return rel_err(*pair) if ok else float("inf")
        return max(pairs, key=err)

    for name, faults in END_FOLD_FAULTS.items():
        compare(f"{name}/nan_scratch", *run(name, 0), TOL_KERNEL)
        for fault, attr in faults.items():
            expect_margin(f"{name}:{fault}",
                          *run(name, getattr(_build, attr)), TOL_KERNEL)


def check_rrdb_tc_faults(gen: torch.Generator, ws3, b: int, h: int,
                         w: int) -> None:
    """Kernel 6's own planted faults (RRDB_TC_FAULTS), each on a fresh x
    with its scratch and output filled with NaN: must miss the bar by
    3x."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt

    flat = [p for ws in ws3 for p in ws]

    def run(bit: int):
        x = rand(gen, b, h, w, 64, scale=0.2, dtype=torch.bfloat16)
        ws = torch.full((b, h, w, 128), float("nan"), dtype=x.dtype,
                        device="cuda")
        tmp = torch.full_like(x, float("nan"))
        out = torch.full_like(x, float("nan"))
        _build.rrdb_tc(x, flat, ws, tmp, out, plant=bit)
        return out, dt.fused_rrdb_reference(x.float(), *ws3)

    for fault, attr in RRDB_TC_FAULTS.items():
        expect_margin(f"fused_rrdb:{fault}", *run(getattr(_build, attr)),
                      TOL_KERNEL)


def lever_frames(model, params, img, geom: dict, default_feats,
                 plain_feats, default_times: dict, card: str) -> dict:
    """Phase 17: the 2K frame through make_tiled_infer_staged with
    fold_ends=True, then with chain_rrdb=True: exact launches per frame
    (fold_ends: kernel 4 once, kernel 5 once, B1 67 calls, and kernels 4
    and 5 by body as END_FOLD_BODIES; chain_rrdb: kernel 6 23 times, B1
    none; the tail's B2 6 and B3 3 in both), shape
    and finiteness; trunk features and the unclipped frame within 0.03 of
    the plain model (the default fused trunk's distance printed); frame
    s, MP/s and trunk ms beside phase 5's. Returns the launches."""
    from superresolution_tpu_torch.infer.fused_trunk import make_fused_trunk
    from superresolution_tpu_torch.infer.phase_tail import make_phase_tail
    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer_staged)

    th, tw = geom["tile"]
    n_tiles = -(-geom["h"] // th) * -(-geom["w"] // tw)
    chunks = -(-n_tiles // TAIL_BATCH)
    nb = model.num_blocks
    expected = {
        "fold_ends": {"fused_dense_block": 5 * (3 * nb - 2),
                      "fused_dense_block_prologue": 1,
                      "fused_dense_block_epilogue": 1},
        "chain_rrdb": {"fused_rrdb": nb}}
    _, plain_tail = make_tiled_infer_staged(
        lambda x: model.trunk(x.to(torch.bfloat16)), model.tail,
        split_stages=True, **geom)
    with torch.inference_mode():
        plain_frame = plain_tail(plain_feats)
    launches = {}
    for lever, want in expected.items():
        fused = make_fused_trunk(params, model, **{lever: True})

        def trunk_fn(x, fused=fused):
            return fused(x.to(torch.bfloat16))

        runner = make_tiled_infer_staged(trunk_fn, make_phase_tail(params),
                                         **geom)
        ops = zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        frame = runner(img)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches[lever] = {k: op.launches for k, op in ops.items()}
        check_launches(lever, launches[lever], {
            **{k: 0 for k in ops}, "up2_hr": 2 * chunks,
            "conv_last_phase": chunks, **want})
        if lever == "fold_ends":
            bodies = {k: by_body(ops[k]) for k in END_FOLD_BODIES}
            BODIES[lever].update(bodies)
            emit({"check": f"{lever}/end_fold_bodies", **bodies})
            if bodies != END_FOLD_BODIES:
                raise AssertionError(f"{lever}: kernels 4 and 5 by body "
                                     f"{bodies} != {END_FOLD_BODIES}")
        if tuple(frame.shape) != (4 * H, 4 * W, 3) or not bool(
                torch.isfinite(frame).all()):
            raise AssertionError(f"{lever}: frame {tuple(frame.shape)} "
                                 "not finite or not 4x")
        emit({"phase": "lever_path", "lever": lever,
              "output_shape": list(frame.shape), "first_run_s": first_s,
              "launches_per_frame": launches[lever],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        del frame
        run_trunk, run_tail = make_tiled_infer_staged(
            trunk_fn, make_phase_tail(params, clip=False), split_stages=True,
            **geom)
        with torch.inference_mode():
            feats = run_trunk(img)
            compare(f"{lever}/trunk_features", feats, plain_feats, TOL_PATH,
                    rel_err_vs_default_fused=rel_err(feats, default_feats))
            compare(f"{lever}/frame_unclipped", run_tail(feats), plain_frame,
                    TOL_PATH)
            frame_s = host_clock(lambda: runner(img))
            trunk_s = host_clock(lambda: run_trunk(img))
        del feats
        torch.cuda.empty_cache()
        emit({"phase": "lever_times", "lever": lever, "card": card,
              "frame_s": frame_s, "mp_per_s": H * W / 1e6 / frame_s,
              "trunk_ms": trunk_s * 1e3, **default_times})
    return launches


def host_clock(fn, runs: int = 2) -> float:
    """Mean host seconds of fn over `runs` runs, each between syncs."""
    t = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    return sum(t) / len(t)


H200_HAT = dict(embed_dim=120, depths=(6,) * 6, num_heads=(6,) * 6,
                window_size=16)
H200_IN = 128             # 128x128 -> 256x256 (stage 2 in) -> 512x512


def attn_geometry_case(cg: torch.Generator, hd: int, n: int, m: int):
    """Kernel 10's f32 inputs at one geometry, laid out as the path has
    them: C = 6 hd; self-attention (m == n) as the split of a packed
    [nb, n, 3C] projection with the Swin region ids of a 256^2 map,
    cross as a contiguous q beside the split of a gathered [nb, m, 2C]
    kv; N(0, 1.5^2) activations and an N(0, 1) bias; nb the windows of
    one 256^2 map (stage 2's side in the h200 frame)."""
    from superresolution_tpu_torch.models.hat_lite import shift_region_ids

    c, ws = 6 * hd, int(n ** 0.5)
    nb = (256 // ws) ** 2

    def randn(*shape):
        return torch.randn(*shape, generator=cg, device="cuda") * 1.5

    ids = None
    if m == n:
        q, k, v = randn(nb, n, 3 * c).split(c, -1)
        ids = torch.as_tensor(shift_region_ids(256, 256, ws, ws // 2),
                              device="cuda")
    else:
        q = randn(nb, n, c)
        k, v = randn(nb, m, 2 * c).split(c, -1)
    bias = torch.randn(6, n, m, generator=cg, device="cuda")
    return q, k, v, bias, ids


def check_attn_geometries(cg: torch.Generator) -> dict:
    """Phase 18a: kernel 10 at every geometry the kernel takes that phase
    12 does not cover (head dim 16 and 20; (n, m) (64, 100), (256, 256),
    (256, 576), and at head dim 20 also (64, 64), (64, 121), (64, 144)),
    shifted (region ids) where m == n: f32 within 1e-4 (5e-4 cross), bf16
    within 0.02; the four planted faults caught at window 16, head dim 20;
    each geometry timed in bf16 beside its bound, the plain version and
    SDPA. Returns the times by geometry."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import window_attention as wa

    bf = torch.bfloat16
    geoms = [(16, 64, 100), (16, 256, 256), (16, 256, 576)] + [
        (20, n, m) for n, m in ((64, 64), (64, 100), (64, 121), (64, 144),
                                (256, 256), (256, 576))]
    times = {}
    for hd, n, m in geoms:
        tag = f"hd{hd}_n{n}_m{m}"
        q, k, v, bias, ids = attn_geometry_case(cg, hd, n, m)
        tol = TOL_ATTN if m == n else TOL_ATTN_CROSS
        check_attn(q, k, v, bias, ids, f"{tag}/f32", tol)
        c = q.shape[-1]
        if m == n:  # keep the packed layout in bf16 too
            qb, kb, vb = torch.cat([q, k, v], -1).to(bf).split(c, -1)
        else:
            qb, kb, vb = (t.to(bf) for t in (q, k, v))
        e16 = check_attn(qb, kb, vb, bias, ids, f"{tag}/bf16",
                         TOL_ATTN_BF16)
        if (hd, n, m) == (20, 256, 256):  # each planted fault must fail
            ref = wa.reference_window_attention(qb, kb, vb, bias, 6, ids)
            for fault, run in (
                    ("region_mask_dropped", lambda: wa.flash_window_attention(
                        qb, kb, vb, bias, 6, None)),
                    ("bias_dropped", lambda: wa.flash_window_attention(
                        qb, kb, vb, torch.zeros_like(bias), 6, ids))):
                expect_caught(f"{tag}:{fault}", lambda: compare(
                    f"planted/{tag}/{fault}", run(), ref, TOL_ATTN_BF16))
            for fault in ("scale_1_over_sqrt_C", "ids_b_div_nw"):
                real = _build.window_attention_tc
                _build.window_attention_tc = _planted_attn(fault)
                try:
                    expect_caught(f"{tag}:{fault}", lambda: compare(
                        f"planted/{tag}/{fault}", wa.flash_window_attention(
                            qb, kb, vb, bias, 6, ids), ref, TOL_ATTN_BF16))
                finally:
                    _build.window_attention_tc = real
        nb = q.shape[0]
        mask = bias.to(bf) if ids is None else (
            bias[None] + wa.region_mask(ids)[:, None]).to(bf)
        sq, sk, sv = (t.reshape(nb, t.shape[1], 6, hd).transpose(1, 2)
                      for t in (qb, kb, vb))
        b_ms, b_by = bound(4 * nb * 6 * n * m * hd,
                           (2 * n + 2 * m) * c * 2 * nb + bias.numel() * 4)
        times[tag] = {
            "ms": time_ms(lambda: wa.flash_window_attention(
                qb, kb, vb, bias, 6, ids), 10),
            "plain_ms": time_ms(lambda: wa.reference_window_attention(
                qb, kb, vb, bias, 6, ids), 5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask), 5),
            "bound_ms": b_ms, "bound_by": b_by, "nb": nb,
            "max_rel_err": e16["max_rel_err"]}
        emit({"phase": "kernel_time", "name": "flash_window_attention",
              "case": tag, **times[tag]})
        old_kernel("flash_window_attention", K10_OLD, list(qb.shape),
                   K10_OLD_MS[tag], "10", case=tag)
        del q, k, v, qb, kb, vb, sq, sk, sv, mask
        torch.cuda.empty_cache()
    return times


def check_hab_oca_geometries(gen: torch.Generator) -> dict:
    """Phase 18b: kernel 8 at (C, heads, n, MLP) (96, 6, 256, 192) and
    (120, 6, 256, 240), kernel 9 at (C, heads, ws, ows) (96, 6, 8, 10),
    (96, 6, 16, 24) and (120, 6, 16, 24), against their plain versions
    within 0.03, on 16 windows of a 64^2 (ws 16) or 32^2 (ws 8) map, HAB
    unmasked and masked; the planted faults of phase 6 caught at window
    16, C 120; each timed at the h200 frame's stage-2 shapes (a 256^2
    map) beside its bound, the plain version and, for kernel 9, SDPA on
    the pre-gathered windows, its exponentials and its replaced kernel's
    time; then kernel 9 on several images with its planted faults
    (check_oca_multi). Returns the times by geometry."""
    from superresolution_tpu_torch.models.hat_lite import shift_region_ids
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import flash_oca as fo
    from superresolution_tpu_torch.ops import hab
    from superresolution_tpu_torch.ops.unfold import (
        extract_overlapping_windows)

    bf = torch.bfloat16
    times = {}
    for c, n, mlp in ((96, 256, 192), (120, 256, 240)):
        tag = f"hab_c{c}_n{n}"
        ws = int(n ** 0.5)
        w8 = hab.mma_weights(hab_check_weights(gen, c, 6, n, mlp))
        ids = torch.as_tensor(shift_region_ids(64, 64, ws, ws // 2),
                              device="cuda")
        xw = rand(gen, 16, n, c, dtype=bf)
        cw = rand(gen, 16, n, c, scale=0.3, dtype=bf)
        e8 = max((check_hab(w8, xw, cw, i, f"{tag}/{name}")
                  for name, i in (("unmasked", None), ("masked", ids))),
                 key=lambda e: e["max_rel_err"])
        if c == 120:
            ref8 = hab.hab_body_reference(xw, cw, w8, 6, ids)
            rpb_t = dict(w8, rpb=w8["rpb"].transpose(1, 2).contiguous())
            for fault, kern in (
                    ("hab_region_ids_dropped", lambda: hab.fused_hab_block(
                        xw, cw, 6, w8, None)),
                    ("hab_rpb_transposed", lambda: hab.fused_hab_block(
                        xw, cw, 6, rpb_t, ids))):
                expect_caught(f"{tag}:{fault}", lambda: compare(
                    f"planted/{tag}/{fault}", kern(), ref8, TOL_HAB))
        nw = (256 // ws) ** 2
        ids_t = torch.as_tensor(shift_region_ids(256, 256, ws, ws // 2),
                                device="cuda")
        xt = rand(gen, nw, n, c, dtype=bf)
        ct = rand(gen, nw, n, c, scale=0.3, dtype=bf)
        tok = nw * n
        macs = c * 3 * c + c * c + 2 * c * mlp + 2 * n * c
        b_ms, b_by = bound(2 * tok * macs, tok * c * 2 * 3
                           + 2 * (c * 3 * c + c * c + 2 * c * mlp))
        times[tag] = {
            "ms": time_ms(lambda: hab.fused_hab_block(xt, ct, 6, w8, ids_t),
                          10),
            "plain_ms": time_ms(lambda: hab.hab_body_reference(
                xt, ct, w8, 6, ids_t), 5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "shape": list(xt.shape), "max_rel_err": e8["max_rel_err"]}
        emit({"phase": "kernel_time", "name": "fused_hab_block", "case": tag,
              **times[tag]})
        old_kernel("fused_hab_block", HAB_OLD, list(xt.shape),
                   HAB_OLD_MS[tag], "8")

    for c, ws, ows in ((96, 8, 10), (96, 16, 24), (120, 16, 24)):
        tag = f"oca_c{c}_ws{ws}_ows{ows}"
        pad = (ows - ws) // 2

        def inputs(side, scale=1.5):
            nw = (side // ws) ** 2
            q = rand(gen, nw, ws * ws, c, scale=scale, dtype=bf)
            maps = [F.pad(rand(gen, 1, side, side, c, scale=scale, dtype=bf),
                          (0, 0, pad, pad, pad, pad)).contiguous()
                    for _ in range(2)]
            return q, *maps, rand(gen, 6, ws * ws, ows * ows)

        q, k_map, v_map, bias = inputs(4 * ws)
        e9 = check_oca(q, k_map, v_map, bias, tag, ws, ows)
        if c == 120:
            ref9 = fo.flash_oca_gathered_reference(q, k_map, v_map, bias, 6,
                                                   ws, ows)
            for fault, kern in (
                    ("oca_bias_zeroed", lambda: fo.flash_oca_gathered(
                        q, k_map, v_map, torch.zeros_like(bias), 6, ws,
                        ows)),
                    ("oca_k_map_shifted", lambda: fo.flash_oca_gathered(
                        q, torch.roll(k_map, 1, 2), v_map, bias, 6, ws,
                        ows))):
                expect_caught(f"{tag}:{fault}", lambda: compare(
                    f"planted/{tag}/{fault}", kern(), ref9, TOL_HAB))
        q, k_map, v_map, bias = inputs(256)
        nh_w = 256 // ws
        tok = q.shape[0] * ws * ws
        sq = q.reshape(-1, ws * ws, 6, c // 6).transpose(1, 2)
        kw, vw = (extract_overlapping_windows(mp, ws, ows, nh_w, nh_w)
                  .reshape(-1, ows * ows, 6, c // 6).transpose(1, 2)
                  for mp in (k_map, v_map))
        b_ms, b_by = bound(2 * tok * 2 * ows * ows * c,
                           tok * c * 2 * 2 + 2 * k_map.numel() * 2
                           + bias.numel() * 4)
        frag = fo.bias_fragments(bias, (c // 6) ** -0.5)  # once, as a model
        times[tag] = {
            "ms": time_ms(lambda: fo.flash_oca_gathered(
                q, k_map, v_map, bias, 6, ws, ows, fragments=frag), 10),
            "plain_ms": time_ms(lambda: fo.flash_oca_gathered_reference(
                q, k_map, v_map, bias, 6, ws, ows), 5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                sq, kw, vw, attn_mask=bias.to(bf)), 5),
            "bound_ms": b_ms, "bound_by": b_by, "shape": list(q.shape),
            "max_rel_err": e9["max_rel_err"]}
        emit({"phase": "kernel_time", "name": "flash_oca_gathered",
              "case": tag, **times[tag], **oca_exps(tok, 6, ows * ows),
              "relay_ms": time_ms(lambda: fo.flash_oca_gathered(
                  q, k_map, v_map, bias, 6, ws, ows), 10)})
        old_kernel("flash_oca_gathered", OCA_OLD, list(q.shape),
                   OCA_OLD_MS[tag], "9", case=tag)
        del q, k_map, v_map, bias, sq, kw, vw
        torch.cuda.empty_cache()
    check_oca_multi(gen)
    return times


# Kernel 9 on several images at ws 16, ows 24 (phase 18b): B 3 of 48 x 80
# maps, 45 windows (no multiple of a window's 4 blocks or of the SMs), 12
# key tiles a window. Its faults are planted on inputs that let each one
# show: q and k N(0, 1), v N(0, 1.5^2), bias N(0, 3^2), so a row's largest
# logits come from the bias, the padded keys carry weight and later tiles
# raise the row max.
OCA_MULTI = (3, 48, 80)
OCA_FAULTS = ("PLANT_PAD_MASKED", "PLANT_NO_RESCALE", "PLANT_ROW_STRIDE")


def check_oca_multi(gen: torch.Generator) -> None:
    """Kernel 9 at OCA_MULTI, C 96 and 120, within 0.03 of its plain
    version; at C 120 each of OCA_FAULTS planted in the kernel and the
    two faults of phase 6 planted in its inputs (bias zeroed, k map
    shifted a column) must miss by 3x the bar."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import flash_oca as fo

    bf = torch.bfloat16
    b, h, w = OCA_MULTI
    ws, ows = 16, 24
    pad = (ows - ws) // 2
    nw = b * (h // ws) * (w // ws)
    for c in (96, 120):
        tag = f"oca_c{c}_ws16_ows24_b{b}"
        q = rand(gen, nw, ws * ws, c, dtype=bf)
        k_map, v_map = (F.pad(rand(gen, b, h, w, c, scale=sc, dtype=bf),
                              (0, 0, pad, pad, pad, pad)).contiguous()
                        for sc in (1.0, 1.5))
        bias = rand(gen, 6, ws * ws, ows * ows, scale=3.0)
        check_oca(q, k_map, v_map, bias, tag, ws, ows)
        if c != 120:
            continue

        def kernel(km=k_map, bs=bias):
            return fo.flash_oca_gathered(q, km, v_map, bs, 6, ws, ows)

        ref = fo.flash_oca_gathered_reference(q, k_map, v_map, bias, 6, ws,
                                              ows)
        for fault in OCA_FAULTS:
            expect_margin(f"{tag}:{fault}",
                          planted("oca", getattr(_build, fault), kernel),
                          ref, TOL_HAB)
        expect_margin(f"{tag}:oca_bias_zeroed",
                      kernel(bs=torch.zeros_like(bias)), ref, TOL_HAB)
        expect_margin(f"{tag}:oca_k_map_shifted",
                      kernel(km=torch.roll(k_map, 1, 2)), ref, TOL_HAB)


def h200_path(gen: torch.Generator, card: str) -> dict:
    """Phase 19: a hybrid_astro_h200-class HybridSR (stage 1 RRDBNet x2,
    23 RRDBs; stage 2 HATLite embed 120, 6 groups of 6, 6 heads of 20,
    window 16), 128^2 -> 512^2, batch 1, bf16, random weights: one frame
    through fused_hybrid_model (B1 345, kernels 7 108, 8 36, 9 6, the
    rest 0) and one through the model with HATLite(flash_attn=True)
    (kernel 10 42, the rest 0), launches exact; stage 1, and stage 2 and
    the smoothing after it on the same input, within 0.03 of the plain
    HybridSR (f32 logits); both whole frames' distances printed; times.
    Returns the launches of both frames."""
    from superresolution_tpu_torch.infer.fused_hat import (
        fused_hybrid_model, make_fused_hat)
    from superresolution_tpu_torch.infer.fused_trunk import fused_rrdb_model
    from superresolution_tpu_torch.ops.blur import anti_checkerboard

    model = hybrid_model(gen, output_size=4 * H200_IN, **H200_HAT)
    params = model.state_dict()
    x = torch.rand((1, H200_IN, H200_IN, 1), generator=gen).to(
        "cuda", torch.bfloat16)
    n_hab, n_grp = sum(model.stage2.depths), len(model.stage2.depths)
    flash = copy.deepcopy(model)
    set_attention(flash, True, False)
    launches = {}
    with torch.inference_mode():
        fused = fused_hybrid_model(params, model)
        frame_plain = model(x)
        for tag, run, want in (
                ("fused", fused, {"fused_dense_block": 69 * 5,
                                  "fused_cab_convs": n_hab,
                                  "fused_hab_block": n_hab,
                                  "flash_oca_gathered": n_grp}),
                ("flash_hatlite", flash,
                 {"flash_window_attention": n_hab + n_grp})):
            ops = zero_counts()
            y = run(x)
            torch.cuda.synchronize()
            launches[tag] = {k: op.launches for k, op in ops.items()}
            check_launches(f"h200/{tag}", launches[tag],
                           {**{k: 0 for k in ops}, **want})
            expect_attn_bodies(f"h200/{tag}",
                               n_hab if tag == "flash_hatlite" else 0)
            if tuple(y.shape) != (1, 4 * H200_IN, 4 * H200_IN, 1) or not \
                    bool(torch.isfinite(y).all()):
                raise AssertionError(f"h200/{tag}: output {tuple(y.shape)}"
                                     " not finite or not x4")
            emit({"check": f"h200/{tag}/frame_end_to_end (printed)",
                  "rel_err": rel_err(y, frame_plain)})
        sub = {k: {n[len(k) + 1:]: v for n, v in params.items()
                   if n.startswith(k + ".")} for k in ("stage1", "stage2")}
        s1 = fused_rrdb_model(sub["stage1"], model.stage1)
        s2 = make_fused_hat(sub["stage2"], model.stage2)
        y1 = s1(x)
        compare("h200/fused/stage1", y1, model.stage1(x), TOL_PATH)
        z = anti_checkerboard(y1, "balanced")
        plain2 = finish(model.stage2, z)
        compare("h200/fused/stage2_and_after", finish(s2, z), plain2,
                TOL_PATH)
        compare("h200/flash_hatlite/stage2_and_after",
                finish(flash.stage2, z), plain2, TOL_PATH)
        times = {f"{tag}_ms": host_clock(lambda: run(x), 3) * 1e3
                 for tag, run in (("fused", fused), ("flash_hatlite", flash),
                                  ("plain", model))}
    emit({"phase": "h200_times", "card": card, **times,
          "fused_mp_per_s": H200_IN ** 2 / 1e3 / times["fused_ms"]})
    return launches


def ows10_path(gen: torch.Generator) -> None:
    """Phase 20: a HATLite at window 8 and overlap 0.25 (ows 10, where
    the gathered kernel 9 covers the even overlap) through make_fused_hat
    within 0.03 of the plain model; kernel 9 once, kernel 10 never."""
    from superresolution_tpu_torch.infer.fused_hat import make_fused_hat
    from superresolution_tpu_torch.models.hat_lite import HATLite

    bf = torch.bfloat16
    hat = HATLite(scale=2, in_channels=1, out_channels=1, embed_dim=96,
                  depths=(2,), num_heads=(6,), window_size=8,
                  overlap_ratio=0.25, generator=gen).to(bf).eval()
    with torch.no_grad():
        for name, p in hat.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    x = torch.rand((1, HYBRID_IN, HYBRID_IN, 1), generator=gen).to("cuda", bf)
    with torch.inference_mode():
        apply = make_fused_hat(hat.state_dict(), hat)
        ops = zero_counts()
        got = apply(x)
        check_launches("ows10", {k: op.launches for k, op in ops.items()},
                       {**{k: 0 for k in ops}, "fused_cab_convs": 2,
                        "fused_hab_block": 2, "flash_oca_gathered": 1})
        compare("ows10/hat", got, hat(x), TOL_PATH,
                ows=hat.layers[0].overlap_attn.ows)


def prebound_upscale(gen: torch.Generator) -> None:
    """Phase 21: api.upscale over fused_rrdb_model (ESRGAN x4, 23 RRDBs,
    RGB) and over fused_hybrid_model (bench_hybrid's widths, its depth cut
    to 4 RRDBs and 2 groups of 2 HABs, no output resize), each a
    PreboundModel, on both tilers: a 256^2 image in 128-tiles with halo
    16, one batch of 4; the tilers within 1e-3 of each other and each
    within 0.03 of api.upscale over the plain module. The models' last
    convs are fitted first (fit_output), so the clip hides little."""
    from superresolution_tpu_torch import api
    from superresolution_tpu_torch.infer.fused_hat import fused_hybrid_model
    from superresolution_tpu_torch.infer.fused_trunk import fused_rrdb_model
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet

    esrgan = RRDBNet(scale=4, in_channels=3, out_channels=3, features=64,
                     num_blocks=23, growth=32, upsampler="pixelshuffle",
                     generator=gen).to(torch.bfloat16).eval()
    fit_output(esrgan, gen, conv=esrgan.conv_last, channels=3)
    hybrid = hybrid_model(gen, output_size=None, num_blocks=4,
                          depths=(2, 2), num_heads=(6, 6))
    fit_output(hybrid, gen)
    kw = dict(tile=128, halo=16, batch=4)
    for name, model, fused, c in (
            ("fused_rrdb_model", esrgan, fused_rrdb_model, 3),
            ("fused_hybrid_model", hybrid, fused_hybrid_model, 1)):
        img = torch.rand((256, 256, c), generator=gen).numpy()
        params = model.state_dict()
        prebound = fused(params, model)
        ops = zero_counts()
        dev = api.upscale(img, 4, model=prebound, params={}, on_device=True,
                          **kw)
        torch.cuda.synchronize()
        if not any(op.launches for op in ops.values()):
            raise AssertionError(f"prebound/{name}: no kernel launched")
        note_unrouted(f"prebound/{name}",
                      {k: op.launches for k, op in ops.items()})
        host = torch.from_numpy(api.upscale(img, 4, model=prebound,
                                            params={}, **kw))
        plain = api.upscale(img, 4, model=model, params=params,
                            on_device=True, **kw)
        d = float((host - dev.cpu()).abs().max())
        emit({"check": f"prebound/{name}/host_vs_on_device",
              "max_abs_diff": d, "tol": TOL_TILERS,
              "launches": {k: op.launches for k, op in ops.items()
                           if op.launches}})
        if d > TOL_TILERS:
            raise AssertionError(f"prebound/{name}: tilers differ by {d}")
        compare(f"prebound/{name}/vs_plain", dev, plain, TOL_PATH,
                inside_0_1=float(((plain > 0) & (plain < 1)).float().mean()))


# ---- 22-26: the fused HAT's deploy levers, kernels 11 and 12 ----------

TOL_PLANT_FACTOR = 3      # a planted fault must show at 3x the bar or more
LEVERS = {"strip": {"SRTPU_STRIP_HAB": "1"},
          "lane_pad": {"SRTPU_LANE_PAD": "1"},
          "xla_cab": {"SRTPU_XLA_CAB": "1"}}


def expect_margin(fault: str, got: torch.Tensor, ref: torch.Tensor,
                  tol: float) -> None:
    """A planted fault's output against the plain version: raise unless
    it misses by TOL_PLANT_FACTOR times the bar or more (non-finite
    values count as caught)."""
    g = got.float()
    rel = rel_err(got, ref) if bool(torch.isfinite(g).all()) else float("inf")
    emit({"planted_fault": fault, "max_rel_err": rel, "tol": tol,
          "caught": rel > TOL_PLANT_FACTOR * tol})
    if not rel > TOL_PLANT_FACTOR * tol:
        raise AssertionError(f"{fault}: planted fault shows only {rel} "
                             f"(< {TOL_PLANT_FACTOR} x {tol})")


def planted(helper: str, bit: int, fn):
    """fn() with `plant=bit` passed to the _build launch helper."""
    import functools

    from superresolution_tpu_torch.ops import _build

    real = getattr(_build, helper)
    setattr(_build, helper, functools.partial(real, plant=bit))
    try:
        return fn()
    finally:
        setattr(_build, helper, real)


STRIP_CASES = (("c96_ws8", 96, 8, 192), ("c96_ws16", 96, 16, 192),
               ("c120_ws16", 120, 16, 240))


def check_strip_kernel(gen: torch.Generator) -> dict:
    """Phase 22: kernel 11 (strip_hab_block) against its plain version on
    the same bf16 inputs within 0.03, on [1,256,256,C] maps at window 8
    (C 96) and 16 (C 96, C 120), shift 0 and ws/2: the output, and out -
    x - bf16(cab_y se) (attention + MLP, which the identity terms would
    hide); se drawn in [0.2, 0.9] so the CAB term is material. Each of
    the three faults planted in the kernel (coordinates clamped in place
    of the wrap, SE not applied, region mask off) must miss by 3x the bar
    at the shifted window 8 and 16 maps. Timed at window 8, shift 4,
    beside the plain version and the windowed route the default path
    takes for the same block (SE glue, rolls, partitions, kernel 8,
    merge, roll back). Returns the kernels-line entry."""
    from superresolution_tpu_torch.models.hat_lite import (
        shift_region_ids, window_merge, window_partition)
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import hab
    from superresolution_tpu_torch.ops import hab_strip as hs

    bf = torch.bfloat16
    side = 2 * HYBRID_IN
    entry = None
    for tag, c, ws, mlp in STRIP_CASES:
        n = ws * ws
        w = hab.mma_weights(hab_check_weights(gen, c, 6, n, mlp))
        x = rand(gen, 1, side, side, c, dtype=bf)
        cab_y = rand(gen, 1, side, side, c, dtype=bf)
        se = (0.2 + 0.7 * torch.rand((1, 1, c), generator=gen)).cuda()
        cab = (cab_y.float() * se.reshape(1, 1, 1, c)).to(bf)
        for shift in (0, ws // 2):
            name = f"strip_hab_block/{tag}/shift{shift}"
            before = hs.strip_hab_block.launches
            got = hs.strip_hab_block(x, cab_y, se, w, num_heads=6,
                                     window_size=ws, shift=shift)
            if hs.strip_hab_block.launches != before + 1:
                raise AssertionError(f"{name}: not one counted launch")
            ref = hs.strip_hab_block_reference(x, cab_y, se, w, 6, ws, shift)
            err = compare(name, got, ref, TOL_HAB)
            ident = x.float() + cab.float()
            compare(f"{name}/attn_mlp", got.float() - ident,
                    ref.float() - ident, TOL_HAB)
            if not shift:
                continue
            if tag != "c96_ws16":
                for bit, fault in ((_build.PLANT_CLAMP, "clamp_not_wrap"),
                                   (_build.PLANT_NO_SE, "se_not_applied"),
                                   (_build.PLANT_NO_MASK, "region_mask_off")):
                    expect_margin(f"strip_hab_block/{tag}:{fault}", planted(
                        "strip_hab", bit, lambda: hs.strip_hab_block(
                            x, cab_y, se, w, num_heads=6, window_size=ws,
                            shift=shift)), ref, TOL_HAB)
            if tag != "c96_ws8":
                continue
            ids = torch.as_tensor(shift_region_ids(side, side, ws, shift),
                                  device="cuda")
            s_bf, one = se.to(bf).reshape(1, 1, 1, c), torch.tensor(1.0,
                                                                     dtype=bf)

            def windowed():
                cb = cab_y * s_bf * one  # the SE and conv_scale passes
                xs = torch.roll(x, (-shift, -shift), dims=(1, 2))
                cb = torch.roll(cb, (-shift, -shift), dims=(1, 2))
                o = hab.fused_hab_block(window_partition(xs, ws).contiguous(),
                                        window_partition(cb, ws).contiguous(),
                                        6, w, ids)
                o = window_merge(o, ws, (side, side))
                return torch.roll(o, (shift, shift), dims=(1, 2)).contiguous()

            compare(f"{name}/windowed_route", windowed(), ref, TOL_PATH)
            tok = side * side
            b_ms, b_by = bound(2 * tok * HAB_MACS,
                               tok * c * 2 * 3 + se.numel() * 4
                               + 2 * (c * 3 * c + c * c + 2 * c * mlp))
            entry = {
                "name": "strip_hab_block", "route": "cuda", "source": HAT_SRC,
                "sources": [HAT_SRC, FLASH_SRC],
                "replaces": "superresolution_tpu/ops/pallas_hab_strip.py:204",
                "shape": list(x.shape), "case": f"{tag}/shift{shift}",
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"], "tol": TOL_HAB,
                "ms": time_ms(lambda: hs.strip_hab_block(
                    x, cab_y, se, w, num_heads=6, window_size=ws,
                    shift=shift), 20),
                "plain_ms": time_ms(lambda: hs.strip_hab_block_reference(
                    x, cab_y, se, w, 6, ws, shift), 10),
                "windowed_ms": time_ms(windowed, 20),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            emit({"phase": "kernel_time", **entry})
            old_kernel("strip_hab_block", HAB_OLD, list(x.shape),
                       HAB_OLD_MS["strip_c96_ws8"], "11")
        del x, cab_y, cab
        torch.cuda.empty_cache()
    return entry


def check_cab_pair_kernel(gen: torch.Generator) -> dict:
    """Phase 23: kernel 12 (fused_cab_convs_pair), one launch of kernel
    7's tensor-core body with the LN divided by C, against its plain
    version (f32 on the bf16 inputs) within 0.02, kernel 7's bar, at
    [1,256,256,96], [1,256,256,120] and a ragged [2,37,46,96] (partial
    tiles at every edge), with kernel 7's check weights (a large LN bias,
    so a conv that saw LN(0) outside the image would differ) packed once.
    Each call is one cab_tc launch counted on kernel 12's count alone:
    kernel 7's counts must not move. Both faults planted in the body (the
    hidden map not zeroed outside the image; each stored column's x XOR
    1, the pixels of a pair swapped) must miss by 3x the bar at C 96 and
    120. Timed at C 96 and 120 beside kernel 7 on the same inputs, with
    the first form's times (K12_OLD_MS) printed. Returns the kernels-line
    entry."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import hab

    bf = torch.bfloat16
    side = 2 * HYBRID_IN
    k7, k12 = hab.fused_cab_convs, hab.fused_cab_convs_pair
    entry, geometries = None, {}
    real_cab_tc = _build.cab_tc
    cab_tc_calls = []

    def spy(*a, **k):
        cab_tc_calls.append(1)
        return real_cab_tc(*a, **k)

    spied = {}
    for tag, c, shape in (("c96", 96, (1, side, side)),
                          ("c120", 120, (1, side, side)),
                          ("ragged_c96", 96, (2, 37, 46))):
        w = hab.cab_mma_weights(cab_check_weights(gen, c, c // 3))
        x = rand(gen, *shape, c, dtype=bf)
        if not hab.uses_tensor_cores(x, c // 3):
            raise AssertionError(f"fused_cab_convs_pair/{tag}: off kernel "
                                 "7's route rule")
        before = (k7.launches, k7.tc_launches, k7.direct_launches,
                  k12.launches)
        cab_tc_calls.clear()
        _build.cab_tc = spy
        try:
            got = k12(x, w)
        finally:
            _build.cab_tc = real_cab_tc
        after = (k7.launches, k7.tc_launches, k7.direct_launches,
                 k12.launches)
        spied[tag] = len(cab_tc_calls)
        emit({"check": f"fused_cab_convs_pair/{tag}/counts",
              "cab_tc_launches": len(cab_tc_calls),
              "kernel7_before": before[:3], "kernel7_after": after[:3],
              "launches": after[3] - before[3]})
        if (len(cab_tc_calls) != 1 or after[:3] != before[:3]
                or after[3] != before[3] + 1):
            raise AssertionError(f"fused_cab_convs_pair/{tag}: not one "
                                 f"cab_tc launch on its own count: "
                                 f"{before} -> {after}, {len(cab_tc_calls)}"
                                 " cab_tc calls")
        ref = hab.fused_cab_convs_pair_reference(x.float(), w)
        err = compare(f"fused_cab_convs_pair/{tag}", got, ref, TOL_KERNEL)
        if tag == "ragged_c96":
            continue
        for bit, fault in ((_build.PLANT_CAB_HID_BORDER, "hidden_not_zeroed"),
                           (_build.PLANT_CAB_SWAP_PAIR, "pair_swapped")):
            expect_margin(f"fused_cab_convs_pair:{tag}:{fault}", planted(
                "cab_tc", bit, lambda: k12(x, w)), ref, TOL_KERNEL)
        px = side * side
        mid = c // 3
        b_ms, b_by = bound(2 * px * 2 * 9 * c * mid,
                           px * c * 2 * 2 + 2 * 9 * c * mid * 2)
        t = {"shape": list(x.shape), "max_abs_err": err["max_abs_err"],
             "max_rel_err": err["max_rel_err"],
             "ms": time_ms(lambda: k12(x, w), 20),
             "queued_ms": queued_ms(lambda: k12(x, w), 20),
             "plain_ms": time_ms(
                 lambda: hab.fused_cab_convs_pair_reference(x, w), 20),
             "kernel7_ms": time_ms(lambda: hab.fused_cab_convs(x, w), 20),
             "kernel7_queued_ms": queued_ms(
                 lambda: hab.fused_cab_convs(x, w), 20),
             "first_form_ms": K12_OLD_MS[tag],
             "bound_ms": b_ms, "bound_by": b_by}
        old_kernel("fused_cab_convs_pair", K12_OLD, list(x.shape),
                   K12_OLD_MS[tag], "12", case=tag)
        geometries[tag] = t
        emit({"phase": "kernel_time", "name": "fused_cab_convs_pair",
              "case": tag, **t})
        if tag == "c96":
            entry = {
                "name": "fused_cab_convs_pair", "route": "cuda",
                "source": CAB_SRC, "sources": [CAB_SRC],
                "replaces": "superresolution_tpu/ops/pallas_hab.py:613",
                **{k: t[k] for k in ("shape", "max_abs_err", "max_rel_err",
                                     "ms", "plain_ms", "bound_ms",
                                     "bound_by")},
                "tol": TOL_KERNEL, "library_ms": None,
                "path": "none: no caller, as in the reference"}
    entry["geometries"] = geometries
    # cab_tc launches of each checked entry call, by the spy (kernel 12
    # has one body); its launches on the system paths come from the tally
    entry["entry_launches_by_body"] = {"tc": spied}
    return entry


def pad_lanes(t: torch.Tensor, dims, to: int = 128) -> torch.Tensor:
    """t zero-padded at the end of each of `dims` to `to`."""
    for d in dims:
        shape = list(t.shape)
        shape[d] = to - t.shape[d]
        t = torch.cat([t, t.new_zeros(shape)], d)
    return t.contiguous()


def check_padded_kernels(gen: torch.Generator) -> dict:
    """Phase 24: kernels 7, 8 and 9 at the lane-padded geometry (C 96 in
    128 lanes, 8 heads of 16, c_real 96), against their plain versions
    (7 within 0.02, 8 and 9 within 0.03) at the bench_hybrid frame's
    stage-2 shapes (a 256^2 map: [1,256,256,128]; 1024 windows of 64;
    kernel 8 unmasked and masked), on inputs and weights padded as
    infer/lane_pad.py pads them; the lanes past 96 of each output must be
    exactly zero. Each timed beside its bound and plain version, kernel 9
    also beside SDPA on the pre-gathered windows. Returns the times by
    kernel."""
    from superresolution_tpu_torch.models.hat_lite import shift_region_ids
    from superresolution_tpu_torch.ops import flash_oca as fo
    from superresolution_tpu_torch.ops import hab
    from superresolution_tpu_torch.ops.unfold import (
        extract_overlapping_windows)

    bf, cr, cp = torch.bfloat16, 96, 128
    side = 2 * HYBRID_IN
    out = {}

    def zero_pads(name, t):
        if bool(t[..., cr:].any()):
            raise AssertionError(f"{name}: pad lanes not zero")

    cw = hab.cab_mma_weights(lane_padded_cab_weights(gen))
    x = pad_lanes(rand(gen, 1, side, side, cr, dtype=bf), [3])
    got = hab.fused_cab_convs(x, cw, c_real=cr)
    e7 = compare("fused_cab_convs/c128_creal96", got,
                 hab.fused_cab_convs_reference(x.float(), cw, c_real=cr),
                 TOL_KERNEL)
    zero_pads("fused_cab_convs/c128", got)
    px = side * side
    out["cab_c128_creal96"] = {
        "ms": time_ms(lambda: hab.fused_cab_convs(x, cw, c_real=cr), 20),
        "plain_ms": time_ms(lambda: hab.fused_cab_convs_reference(
            x, cw, c_real=cr), 10),
        "max_rel_err": e7["max_rel_err"],
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * px * CAB_MACS, px * cp * 2 * 2 + 2 * 9 * cp * 32 * 2)))}

    w = hab_check_weights(gen)
    wq = w["wqkv"].float()
    w = dict(w, **{
        k: pad_lanes(w[k], [0]) for k in ("ln1_s", "ln1_b", "bp", "ln2_s",
                                          "ln2_b", "b2")})
    w["wqkv"] = pad_lanes(torch.cat([pad_lanes(s, [1])
                                     for s in wq.split(cr, 1)], 1), [0]).to(bf)
    w["bqkv"] = torch.cat([pad_lanes(s, [0])
                           for s in w["bqkv"].split(cr)]).contiguous()
    w["rpb"] = pad_lanes(w["rpb"], [0], 8)
    w["wp"] = pad_lanes(w["wp"], [0, 1])
    w["w1"], w["w2"] = pad_lanes(w["w1"], [0]), pad_lanes(w["w2"], [1])
    w = hab.mma_weights(w)
    nw = (side // 8) ** 2
    xw = pad_lanes(rand(gen, nw, 64, cr, dtype=bf), [2])
    cwin = pad_lanes(rand(gen, nw, 64, cr, scale=0.3, dtype=bf), [2])
    ids = torch.as_tensor(shift_region_ids(side, side, 8, 4), device="cuda")
    errs = []
    for tag, i in (("unmasked", None), ("masked", ids)):
        got = hab.fused_hab_block(xw, cwin, 8, w, i, c_real=cr)
        errs.append(compare(
            f"fused_hab_block/c128_creal96/{tag}", got,
            hab.hab_body_reference(xw, cwin, w, 8, i, c_real=cr), TOL_HAB))
        zero_pads(f"fused_hab_block/c128/{tag}", got)
    tok = nw * 64
    out["hab_c128_nh8_n64"] = {
        "ms": time_ms(lambda: hab.fused_hab_block(xw, cwin, 8, w, ids,
                                                  c_real=cr), 20),
        "plain_ms": time_ms(lambda: hab.hab_body_reference(
            xw, cwin, w, 8, ids, c_real=cr), 10),
        "max_rel_err": max(e["max_rel_err"] for e in errs),
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * tok * (cp * 4 * cp + 2 * cp * 192 + 2 * 64 * cp),
            tok * cp * 2 * 3 + 2 * (cp * 4 * cp + 2 * cp * 192))))}
    old_kernel("fused_hab_block", HAB_OLD, list(xw.shape),
               HAB_OLD_MS["hab_c128_nh8_n64"], "8")

    q = pad_lanes(rand(gen, nw, 64, cr, scale=1.5, dtype=bf), [2])
    k_map, v_map = (pad_lanes(F.pad(rand(gen, 1, side, side, cr, scale=1.5,
                                         dtype=bf), (0, 0, 2, 2, 2, 2)), [3])
                    for _ in range(2))
    bias = pad_lanes(rand(gen, 6, 64, 144), [0], 8)
    got = fo.flash_oca_gathered(q, k_map, v_map, bias, 8, 8, 12)
    e9 = compare("flash_oca_gathered/c128_nh8", got,
                 fo.flash_oca_gathered_reference(q, k_map, v_map, bias, 8, 8,
                                                 12), TOL_HAB)
    zero_pads("flash_oca_gathered/c128", got)
    # the library yardstick as at C 96 (phase 6): SDPA on the
    # pre-gathered windows, the gather itself not in the call
    sq = q.reshape(-1, 64, 8, 16).transpose(1, 2)
    kw, vw = (extract_overlapping_windows(m, 8, 12, side // 8, side // 8)
              .reshape(-1, 144, 8, 16).transpose(1, 2)
              for m in (k_map, v_map))
    frag = fo.bias_fragments(bias, 0.25)  # once, as a model passes it
    out["oca_c128_nh8_ws8_ows12"] = {
        "ms": time_ms(lambda: fo.flash_oca_gathered(
            q, k_map, v_map, bias, 8, 8, 12, fragments=frag), 20),
        "plain_ms": time_ms(lambda: fo.flash_oca_gathered_reference(
            q, k_map, v_map, bias, 8, 8, 12), 10),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            sq, kw, vw, attn_mask=bias.to(bf)), 20),
        "max_rel_err": e9["max_rel_err"],
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * tok * 2 * 144 * cp, tok * cp * 2 * 2 + 2 * k_map.numel() * 2
            + bias.numel() * 4)))}
    relay = {**oca_exps(tok, 8, 144), "relay_ms": time_ms(
        lambda: fo.flash_oca_gathered(q, k_map, v_map, bias, 8, 8, 12), 20)}
    for tag, t in out.items():  # the exponentials, relay_ms on the line
        emit({"phase": "kernel_time", "case": tag, **t, **(
            relay if tag.startswith("oca_") else {})})
    old_kernel("flash_oca_gathered", OCA_OLD, list(q.shape),
               OCA_OLD_MS["oca_c128_nh8_ws8_ows12"], "9",
               case="oca_c128_nh8_ws8_ows12")
    return out


class lever_env:
    """Set a lever's environment variables for a with-block, then restore
    the environment as it was."""

    def __init__(self, env: dict):
        self.env, self.saved = env, {}

    def __enter__(self):
        for k, v in self.env.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def launch_channels(fn) -> tuple:
    """fn() with the channel count of every kernel-8 and kernel-9 launch
    recorded (the _build launch helpers wrapped). Returns (fn's result,
    {'fused_hab_block': [C, ...], 'flash_oca_gathered': [C, ...]})."""
    from superresolution_tpu_torch.ops import _build

    seen = {"fused_hab_block": [], "flash_oca_gathered": []}
    real = {"hab_block": _build.hab_block, "oca": _build.oca}

    def hab_block(x, *a, **k):
        seen["fused_hab_block"].append(x.shape[-1])
        return real["hab_block"](x, *a, **k)

    def oca(q, *a, **k):
        seen["flash_oca_gathered"].append(q.shape[-1])
        return real["oca"](q, *a, **k)

    _build.hab_block, _build.oca = hab_block, oca
    try:
        return fn(), seen
    finally:
        _build.hab_block, _build.oca = real["hab_block"], real["oca"]


def device_ms(fn) -> float | None:
    """Device time of one call of fn after a warm-up: the sum of its CUDA
    kernels' self time (torch.profiler), None if the profiler sees none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 if us else None


def launch_device_ms(fn, calls: int = 20) -> float | None:
    """Device time of one call of fn, a call that launches each of its
    kernels once: the sum over its kernels of their mean self time under
    torch.profiler over `calls` calls, after a warm-up; None if the
    profiler sees none. A mean, not device_ms's sum: after phase 32's
    training the profiler drops the first kernel records of a profiled
    block, more the later in the run (by phase 36, 8 of 10 calls)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    means = [e.self_device_time_total / e.count for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    return sum(means) / 1e3 if means else None


def lever_frame(model, params, x, z, lever: str, want: dict,
                channels: dict, tag: str) -> dict:
    """One frame through fused_hybrid_model under `lever` (None: the
    default) with every launch counted (exact: `want`, the rest 0) and
    kernels 8 and 9's channels recorded (each `channels[k]`); shape and
    finiteness; the frame after stage 2, fed the kernel path's own
    stage-2 input z, within 0.03 of the plain HybridSR (phase 7's rule),
    and the whole frame too; stage 2's own output (before the smoothing
    that follows it) and its distance from the plain stage 2, printed;
    frame ms and stage 2's host and device ms. Returns the launches, the
    times and stage 2's output."""
    from superresolution_tpu_torch.infer.fused_hat import (
        fused_hybrid_model, make_fused_hat)

    stage2 = {n[len("stage2."):]: v for n, v in params.items()
              if n.startswith("stage2.")}
    with lever_env(LEVERS.get(lever, {})), torch.inference_mode():
        fused = fused_hybrid_model(params, model)
        ops = zero_counts()
        y, seen = launch_channels(lambda: fused(x))
        torch.cuda.synchronize()
        launches = {k: op.launches for k, op in ops.items()}
        check_launches(f"{tag}/{lever}", launches,
                       {**{k: 0 for k in ops}, **want})
        expect_attn_bodies(f"{tag}/{lever}")
        for k, c in channels.items():
            if set(seen[k]) != {c}:
                raise AssertionError(f"{tag}/{lever}: {k} launched at C "
                                     f"{sorted(set(seen[k]))}, not {c}")
        side = 4 * x.shape[1]
        if tuple(y.shape) != (1, side, side, 1) or not bool(
                torch.isfinite(y).all()):
            raise AssertionError(f"{tag}/{lever}: output {tuple(y.shape)} "
                                 "not finite or not x4")
        s2 = make_fused_hat(stage2, model.stage2)
        y2 = s2(z)
        compare(f"{tag}/{lever}/frame", y, finish(model.stage2, z), TOL_PATH,
                stage2_rel_err=rel_err(y2, model.stage2(z)),
                stage2_channels={k: sorted(set(v)) for k, v in seen.items()})
        compare(f"{tag}/{lever}/frame_end_to_end", y, model(x), TOL_PATH)
        times = {"frame_ms": host_clock(lambda: fused(x), 5) * 1e3,
                 "stage2_ms": host_clock(lambda: s2(z), 5) * 1e3,
                 "stage2_device_ms": device_ms(lambda: s2(z))}
    emit({"phase": "lever_frame", "model": tag, "lever": lever,
          "launches_per_frame": {k: v for k, v in launches.items() if v},
          **times})
    return {"launches": launches, "stage2_out": y2, **times}


def hat_lever_paths(gen: torch.Generator, card: str) -> dict:
    """Phases 25 and 26: bench_hybrid's frame (128^2 -> 512^2, stage 2
    HATLite embed 96, 4 x 6 HABs, window 8) through fused_hybrid_model
    under SRTPU_STRIP_HAB (kernel 11 x24, kernel 8 x0), SRTPU_LANE_PAD
    (kernels 8 x24 and 9 x4, all at C 128) and SRTPU_XLA_CAB (kernel 7
    x0), one at a time, between two runs of the default frame; then the
    hybrid_astro_h200-class frame (embed 120, 6 x 6 HABs, head dim 20,
    window 16) under the strip lever (kernel 11 x36 at window 16, C 120)
    and under lane pad, which does not apply at head dim 20 (128 % 20):
    the frame runs unpadded, kernels 8 and 9 at C 120. Returns kernel
    11's launches in bench_hybrid's strip frame."""
    from superresolution_tpu_torch.infer.fused_trunk import fused_rrdb_model
    from superresolution_tpu_torch.ops.blur import anti_checkerboard

    bf = torch.bfloat16
    out = {}
    for tag, hat, side in (("bench_hybrid", {}, HYBRID_IN),
                           ("h200", H200_HAT, H200_IN)):
        model = hybrid_model(gen, output_size=4 * side, **hat)
        params = model.state_dict()
        x = torch.rand((1, side, side, 1), generator=gen).to("cuda", bf)
        with torch.inference_mode():
            z = anti_checkerboard(fused_rrdb_model(
                {n[len("stage1."):]: v for n, v in params.items()
                 if n.startswith("stage1.")}, model.stage1)(x), "balanced")
        n_hab, n_grp = sum(model.stage2.depths), len(model.stage2.depths)
        c = model.stage2.embed_dim
        cp = 128 if c == 96 else c  # lane pad applies at head dim 16 only
        base = {"fused_dense_block": 69 * 5, "fused_cab_convs": n_hab,
                "fused_hab_block": n_hab, "flash_oca_gathered": n_grp}
        plain = {"fused_hab_block": c, "flash_oca_gathered": c}
        cases = [("default", base, plain),
                 ("strip", {**base, "fused_hab_block": 0,
                            "strip_hab_block": n_hab},
                  {"flash_oca_gathered": c}),
                 ("lane_pad", base, {"fused_hab_block": cp,
                                     "flash_oca_gathered": cp})]
        if tag == "bench_hybrid":
            cases.append(("xla_cab", {**base, "fused_cab_convs": 0}, plain))
        cases.append(("default_again", base, plain))
        res = {lever: lever_frame(model, params, x, z, lever, want, chans,
                                  tag)
               for lever, want, chans in cases}
        default2 = res["default"]["stage2_out"]
        for lever, r in res.items():  # how far each lever moves stage 2
            emit({"check": f"{tag}/{lever}/stage2_vs_default (printed)",
                  "rel_err": rel_err(r.pop("stage2_out"), default2)})
        del default2
        emit({"phase": "lever_times", "model": tag, "card": card,
              **{f"{k}_{m}": v[m] for k, v in res.items()
                 for m in ("frame_ms", "stage2_ms", "stage2_device_ms")},
              "lane_pad_applied": cp != c})
        if cp == c:
            emit({"check": f"{tag}/lane_pad", "ran_unpadded_at_C": c,
                  "why": f"head dim {c // model.stage2.num_heads[0]} does "
                         "not divide 128"})
        out[tag] = res["strip"]["launches"]["strip_hab_block"]
        del model, params
        torch.cuda.empty_cache()
    return out["bench_hybrid"]


# ---- 27-30: EDSR and ESPCN serving through kernel 15 ------------------

SUB_SRC = "superresolution_tpu_torch/ops/csrc/subpixel_kernels.cu"
ENGINE_SRC = "superresolution_tpu_torch/ops/csrc/conv_engine.cuh"
TOL_SUB_F32 = 1e-4        # f32 kernel against the f32 plain version
TOL_PSNR = 0.05           # VERDICT.md's bar, here kernel against plain op
TOL_SSIM = 0.002
EVAL_DIR = "outputs/chip_smoke_eval"     # .gitignore lists outputs/
# (tag, B, H, W, C_in, C_out, r, channels-last input)
SUB_CASES = (("pallas_r2", 2, 16, 24, 8, 4, 2, True),
             ("pallas_r4", 2, 16, 24, 16, 1, 4, False),
             ("ragged_r3", 2, 37, 53, 24, 3, 3, True),
             ("edsr_stage1", UP_BATCH, UP_TILE + 2 * UP_HALO,
              UP_TILE + 2 * UP_HALO, 64, 64, 2, True),
             ("edsr_stage2", UP_BATCH, 2 * (UP_TILE + 2 * UP_HALO),
              2 * (UP_TILE + 2 * UP_HALO), 64, 64, 2, True),
             ("espcn", UP_BATCH, UP_TILE + 2 * UP_HALO,
              UP_TILE + 2 * UP_HALO, 32, 1, 4, True))
SUB_FAULTS = ("PLANT_SWAP_IJ", "PLANT_CLAMP_BORDER", "PLANT_NO_BIAS")


def subpixel_case(gen: torch.Generator, b, h, w, cin, cout, r, cl):
    """Kernel 15's f32 inputs on the card: x N(0, 1) (channels-last as
    the port's convs hand it over, or NCHW), w N(0, 1 / (9 C_in)) in
    OIHW, bias N(0, 0.5^2), so the bias and every tap show in the output."""
    x = torch.randn((b, cin, h, w), generator=gen).cuda()
    if cl:
        x = x.contiguous(memory_format=torch.channels_last)
    wt = (torch.randn((cout * r * r, cin, 3, 3), generator=gen)
          / (9 * cin) ** 0.5).cuda()
    bias = (0.5 * torch.randn(cout * r * r, generator=gen)).cuda()
    return x, wt, bias


def check_subpixel_kernel(gen: torch.Generator) -> dict:
    """Phase 27: kernel 15 against its plain version at SUB_CASES in both
    bodies of the conv engine: bf16 within 0.02 (the bar of the other
    conv kernels, B1-B3; CHIPEQ has no row for it) and f32 within 1e-4
    of max |plain| (plain in f32 with TF32 off, on the same values). The
    route rule must pick the tensor-core body for bf16 channels-last
    inputs (every case but the NCHW pallas_r4) and the direct body for
    f32 and NCHW, as the per-body counts show; at the path shapes the
    direct body also runs in bf16 through its launch helper. Each fault
    planted in the kernel must miss by 3x the bar: in the tensor-core
    body at the ragged and EDSR stage-1 geometries in bf16, in the
    direct body at the ragged one in f32. Timed at the path shapes
    beside the direct body in bf16, the plain version and F.conv2d alone
    (cuDNN). Returns the kernels-line entry (EDSR stage 1) with every
    path shape under 'geometries'."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import subpixel as sp

    op, plain = sp.conv3x3_depth_to_space, sp.reference_conv3x3_depth_to_space
    bf = torch.bfloat16
    faults_at = {bf: ("ragged_r3", "edsr_stage1"), torch.float32: (
        "ragged_r3",)}
    geometries = {}
    for tag, b, h, w, cin, cout, r, cl in SUB_CASES:
        x, wt, bias = subpixel_case(gen, b, h, w, cin, cout, r, cl)
        with torch.inference_mode():
            for dt, tol in ((torch.float32, TOL_SUB_F32), (bf, TOL_KERNEL)):
                xd, wd, bd = x.to(dt), wt.to(dt), bias.to(dt)
                body = "tc" if dt == bf and cl else "direct"
                if sp.uses_tensor_cores(xd) != (body == "tc"):
                    raise AssertionError(f"conv3x3_depth_to_space/{tag}: the "
                                         f"route rule does not pick {body}")
                zero_counts()
                got = op(xd, wd, bd, r)
                if op.launches != 1 or getattr(op, f"{body}_launches") != 1:
                    raise AssertionError("conv3x3_depth_to_space: not one "
                                         f"counted {body} launch")
                if got.dtype != dt or tuple(got.shape) != (b, cout, h * r,
                                                           w * r):
                    raise AssertionError(f"conv3x3_depth_to_space/{tag}: "
                                         f"{got.dtype} {tuple(got.shape)}")
                ref = plain(xd.float(), wd.float(), bd.float(), r)
                err = compare(f"conv3x3_depth_to_space/{tag}/{dt}/{body}",
                              got, ref, tol)
                del got
                for fault in SUB_FAULTS if tag in faults_at[dt] else ():
                    expect_margin(
                        f"conv3x3_depth_to_space:{tag}:{body}:{fault}",
                        planted("conv3x3_d2s", getattr(_build, fault),
                                lambda: op(xd, wd, bd, r)), ref, tol)
            if not tag.startswith(("edsr", "espcn")):
                continue
            # the direct body in bf16 at the path shape, through its helper
            wk, bk = sp.kmajor_weights(wd, bd, r, bf)
            out = torch.empty((b, h * r, w * r, cout), dtype=bf,
                              device="cuda")

            def direct():
                _build.conv3x3_d2s(xd, wk, bk, r, out, False)

            direct()
            d_err = compare(f"conv3x3_depth_to_space/{tag}/bf16/direct",
                            out.permute(0, 3, 1, 2), ref, TOL_KERNEL)
            del ref
            px = b * h * w
            b_ms, b_by = bound(2 * px * 9 * cin * cout * r * r,
                               2 * (px * cin + px * r * r * cout
                                    + wt.numel() + bias.numel()))
            geometries[tag] = {
                "shape": [b, cin, h, w], "c_out": cout, "r": r,
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"],
                "direct_max_rel_err": d_err["max_rel_err"],
                "ms": time_ms(lambda: op(xd, wd, bd, r), 10),
                "direct_ms": time_ms(direct, 2),
                "plain_ms": time_ms(lambda: plain(xd, wd, bd, r), 10),
                "library_ms": time_ms(
                    lambda: F.conv2d(xd, wd, bd, padding=1), 10),
                "bound_ms": b_ms, "bound_by": b_by}
            emit({"phase": "kernel_time", "name": "conv3x3_depth_to_space",
                  "geometry": tag, **geometries[tag]})
        del x, xd, wt, wd, out
        torch.cuda.empty_cache()
    main = geometries["edsr_stage1"]
    return {"name": "conv3x3_depth_to_space", "route": "cuda",
            "source": SUB_SRC, "sources": [SUB_SRC, ENGINE_SRC],
            "replaces": "superresolution_tpu/ops/pallas_kernels.py:64",
            **{k: main[k] for k in ("shape", "max_abs_err", "max_rel_err",
                                    "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "direct_ms")},
            "tol": TOL_KERNEL, "geometries": geometries,
            "ptxas": PTXAS.get("Subpixel")}


@contextlib.contextmanager
def plain_subpixel():
    """Inside the block, the models' sub-pixel heads run the plain op
    (F.conv2d, F.pixel_shuffle) in place of kernel 15: the reference for
    phases 28-30's kernel paths."""
    from superresolution_tpu_torch.models import edsr, espcn
    from superresolution_tpu_torch.ops.subpixel import (
        reference_conv3x3_depth_to_space)

    mods = (edsr, espcn)
    real = [m.conv3x3_depth_to_space for m in mods]
    for m in mods:
        m.conv3x3_depth_to_space = reference_conv3x3_depth_to_space
    try:
        yield
    finally:
        for m, fn in zip(mods, real):
            m.conv3x3_depth_to_space = fn


def frame_profile(fn) -> dict:
    """One call of fn under torch.profiler: host s, device ms (the sum of
    its CUDA kernels' self time), busy share and the top kernels."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    on_card = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    return {"profiled_frame_s": prof_s,
            # None when the profiler saw no device time
            "device_ms_per_frame": device_ms or None,
            "device_busy_share": device_ms / (prof_s * 1e3) if device_ms
            else None,
            "top_device_kernels": [
                {"kernel": e.key[:240], "ms": e.self_device_time_total / 1e3,
                 "count": e.count} for e in on_card[:12]]}


def sr_model(name: str, gen: torch.Generator, channels: int):
    """EDSR-baseline x4 (utils/config.py's edsr_baseline_x4) or ESPCN x4
    (espcn_x4) at full width, bf16, on the card, random weights with
    N(0, 0.02) biases, the last conv fitted so a frame spreads over [0, 1]
    (fit_output; EDSR's output is then recentred on 0.5, since its DIV2K
    mean is added after conv_last)."""
    from superresolution_tpu_torch.models.factory import build_from_config
    from superresolution_tpu_torch.utils.config import get_preset

    mc = get_preset({"edsr": "edsr_baseline_x4", "espcn": "espcn_x4"}[name]
                    ).model
    model = build_from_config(mc, generator=gen).to(torch.bfloat16).eval()
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    conv = model.conv_last if name == "edsr" else model.conv3
    fit_output(model, gen, conv=conv, channels=channels)
    if name == "edsr":
        side = UP_TILE + 2 * UP_HALO
        x = torch.rand((1, side, side, channels), generator=gen).to(
            "cuda", torch.bfloat16)
        with torch.inference_mode():
            m = float(model(x).float().mean())
        with torch.no_grad():
            conv.bias.add_(0.5 - m)
        emit({"check": f"{name}/output_recentred", "mean_before": m})
    return mc, model


def sr_upscale_path(name: str, gen: torch.Generator, card: str,
                    channels: int, stages: int):
    """Phases 28 and 29: a FRAME^2 frame through api.upscale (on-device
    tiler, 256 tiles + halo 16, batches of 8) over `name`'s model with
    kernel-15 launches counted (exact: stages per batch, every other
    kernel 0); against the same call with the plain op and the host
    tiler; times and the profile. Returns (model config, model, kernel-15
    launches)."""
    from superresolution_tpu_torch import api

    mc, model = sr_model(name, gen, channels)
    params = model.state_dict()
    frame = torch.rand((FRAME, FRAME, channels), generator=gen).numpy()
    kw = dict(model=model, params=params, tile=UP_TILE, halo=UP_HALO,
              batch=UP_BATCH)
    side = 4 * FRAME
    ops = zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y = api.upscale(frame, 4, on_device=True, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: op.launches for k, op in ops.items()}
    batches = -(-(FRAME // UP_TILE) ** 2 // UP_BATCH)
    check_launches(name, launches, {**{k: 0 for k in ops},
                                    "conv3x3_depth_to_space":
                                    batches * stages})
    bodies = expect_tc_body(name, ops["conv3x3_depth_to_space"])
    if tuple(y.shape) != (side, side, channels):
        raise AssertionError(f"{name}: output shape {tuple(y.shape)}")
    if not bool(torch.isfinite(y).all()) or float(y.min()) < 0 \
            or float(y.max()) > 1:
        raise AssertionError(f"{name}: output not finite in [0, 1]")
    emit({"phase": f"{name}_upscale_path", "output_shape": list(y.shape),
          "first_run_s": first_s, "launches_per_frame": launches,
          "kernel15_bodies": bodies, "batches": batches,
          "inside_0_1": float(((y > 0) & (y < 1)).float().mean()),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    with plain_subpixel():
        y_plain = api.upscale(frame, 4, on_device=True, **kw)
    compare(f"{name}/frame_vs_plain_op", y, y_plain, TOL_PATH)
    del y_plain
    y_host = torch.from_numpy(api.upscale(frame, 4, on_device=False,
                                          blend="crop", **kw))
    d_host = float((y_host - y.cpu()).abs().max())
    emit({"check": f"{name}/host_tiler_vs_on_device", "max_abs_diff": d_host,
          "tol": TOL_TILERS})
    if d_host > TOL_TILERS:
        raise AssertionError(f"{name}: host tiler {d_host} from the "
                             "on-device one")
    del y_host, y
    torch.cuda.reset_peak_memory_stats()
    frame_s = host_clock(lambda: api.upscale(frame, 4, on_device=True, **kw))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with plain_subpixel():
        torch.cuda.reset_peak_memory_stats()
        plain_s = host_clock(lambda: api.upscale(frame, 4, on_device=True,
                                                 **kw))
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": f"{name}_upscale_times", "card": card, "frame_s": frame_s,
          "mp_per_s": FRAME ** 2 / 1e6 / frame_s, "plain_frame_s": plain_s,
          "plain_mp_per_s": FRAME ** 2 / 1e6 / plain_s,
          "peak_mem_gib": peak, "plain_peak_mem_gib": plain_peak,
          **frame_profile(lambda: api.upscale(frame, 4, on_device=True,
                                              **kw))})
    return mc, model, launches["conv3x3_depth_to_space"]


def eval_folder_path(mc, model, gen: torch.Generator) -> None:
    """Phase 30: `model` saved as a checkpoint directory with its
    model_config.json, loaded back and rebuilt as cli/main.py's
    cmd_eval_folder does, and scored by evaluate_folder through
    api.upscale on 4 synthetic HR PNGs (two 512^2, two 517x383 for the
    centre crop): PSNR within 0.05 dB and SSIM within 0.002 of the same
    evaluation with the plain op; kernel-15 launches exact (2 a frame)."""
    import dataclasses
    import shutil

    from superresolution_tpu_torch import api
    from superresolution_tpu_torch.data.io import save_png
    from superresolution_tpu_torch.metrics.benchmark_eval import (
        evaluate_folder)
    from superresolution_tpu_torch.models.factory import (
        build_from_config, total_scale)
    from superresolution_tpu_torch.ops.subpixel import conv3x3_depth_to_space
    from superresolution_tpu_torch.train.checkpoint import (
        CheckpointManager, load_params_for_inference)
    from superresolution_tpu_torch.train.state import TrainState
    from superresolution_tpu_torch.utils.config import ModelConfig

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    hr_dir, ckpt = f"{EVAL_DIR}/hr", f"{EVAL_DIR}/ckpt"
    shapes = ((512, 512), (512, 512), (517, 383), (383, 517))
    for i, (h, w) in enumerate(shapes):
        save_png(torch.rand((h, w, 3), generator=gen).numpy(),
                 f"{hr_dir}/img{i}.png")
    sd = {k: v.float() for k, v in model.state_dict().items()}
    CheckpointManager(ckpt, model_config=dataclasses.asdict(mc)).save(
        TrainState(step=0, params=sd, opt_state={}), 0, psnr=0.0)
    params, cfg = load_params_for_inference(ckpt, with_config=True)
    cfg.pop("output_size", None)
    mcfg = ModelConfig(**cfg)
    built = build_from_config(mcfg, output_size=None)
    scale = total_scale(mcfg)

    def up(lr):
        return api.upscale(lr, scale, model=built, params=params,
                           tile=UP_TILE, halo=UP_HALO)

    # the host tiler's batches of 8 tiles, each through both x2 stages
    want = sum(2 * math.ceil(math.ceil(h // scale / UP_TILE)
                             * math.ceil(w // scale / UP_TILE) / 8)
               for h, w in shapes)
    ops = zero_counts()
    t0 = time.perf_counter()
    got = evaluate_folder(up, hr_dir, scale)
    eval_s = time.perf_counter() - t0
    n_launch = conv3x3_depth_to_space.launches
    note_unrouted("eval_folder", {k: op.launches for k, op in ops.items()})
    if n_launch != want:
        raise AssertionError(f"eval_folder: {n_launch} kernel-15 launches, "
                             f"expected {want}")
    bodies = expect_tc_body("eval_folder", conv3x3_depth_to_space)
    with plain_subpixel():
        ref = evaluate_folder(up, hr_dir, scale)
    d_psnr, d_ssim = abs(got["psnr"] - ref["psnr"]), abs(got["ssim"]
                                                         - ref["ssim"])
    emit({"phase": "eval_folder", "model": cfg["name"], "scale": scale,
          "n": got["n"], "psnr": got["psnr"], "ssim": got["ssim"],
          "plain_psnr": ref["psnr"], "plain_ssim": ref["ssim"],
          "d_psnr": d_psnr, "d_ssim": d_ssim, "tol_psnr": TOL_PSNR,
          "tol_ssim": TOL_SSIM, "kernel15_launches": n_launch,
          "kernel15_bodies": bodies, "eval_s": eval_s})
    if got["n"] != len(shapes) or d_psnr > TOL_PSNR or d_ssim > TOL_SSIM:
        raise AssertionError(f"eval_folder: {got} against the plain op's "
                             f"{ref}")


# ---- 31-34: single-device training at the reference's defaults --------

SEG_IMAGES, SEG_LR = 8, 48   # esrgan_x4_tiled: batch 8, LR 192 / 4
SEG_FAULTS = ("stride_h", "valid_is_stride", "spacer_not_zeroed")
DEFAULTS_DIR = "outputs/chip_smoke_defaults"    # .gitignore lists outputs/
MANIFEST_DIR = "outputs/chip_smoke_manifest"
PRESET_STEPS = {"esrgan_x4_tiled": 3, "edsr_baseline_x4": 3, "srcnn_x2": 2,
                "espcn_x4": 2, "fsrcnn_x4": 2, "hybrid_astro": 2}
TOL_DEGRADE = 1e-4        # LR made on the card against the CPU (f32)
TOL_JPEG_SHARE = 0.01     # pixels past it allowed where a DCT coefficient
                          # at a .5 quantization tie rounds the other way


def seg_fault(fault: str | None, seg: tuple) -> tuple:
    """(the seg the kernels are given, seg_plant) with `fault` planted:
    stride_h, a spacer every H rows instead of every H + 1; valid_is_stride,
    no row masked; spacer_not_zeroed, every store leaves the spacer rows
    as computed."""
    stride, valid = seg
    return {None: (seg, 0), "stride_h": ((valid, valid - 1), 0),
            "valid_is_stride": ((stride, stride), 0),
            "spacer_not_zeroed": (seg, 1)}[fault]


@contextlib.contextmanager
def seg_planted(bit: int):
    """Inside the block every conv launch (either body of B1, kernel 13's
    transposed convs on either route) gets seg_plant=bit."""
    import functools

    from superresolution_tpu_torch.ops import _build

    real = {k: getattr(_build, k)
            for k in ("conv3x3", "dense_conv", "grad_conv")}
    if bit:
        for k, fn in real.items():
            setattr(_build, k, functools.partial(fn, seg_plant=bit))
    try:
        yield
    finally:
        for k, fn in real.items():
            setattr(_build, k, fn)


def spacer_rows_zero(name: str, t: torch.Tensor, seg: tuple) -> None:
    """Raise unless every spacer row of the NHWC map t is exactly 0."""
    from superresolution_tpu_torch.ops.dense_trunk import image_rows

    sp = ~image_rows(t.shape[1], seg, t.device)
    nonzero = int((t[:, sp] != 0).sum())
    emit({"check": f"{name}/spacer_rows", "rows": int(sp.sum()),
          "nonzero": nonzero})
    if nonzero:
        raise AssertionError(f"{name}: {nonzero} nonzero values on the "
                             "spacer rows")


def seg_forward_pairs(ws, x, res, seg, fault=None) -> dict:
    """B1 with seg (and `fault` planted) against its plain seg form in f32
    on the same upcast inputs, the RRDB residual folded: {check: (got,
    ref, bar)}."""
    from superresolution_tpu_torch.ops import dense_trunk as dt

    kseg, bit = seg_fault(fault, seg)
    with seg_planted(bit):
        got = dt.fused_dense_block(x, ws, res, seg=kseg)
    ref = dt.fused_dense_block_reference(x.float(), ws, res.float(), seg=seg)
    return {"value": (got, ref, TOL_KERNEL)}


def seg_backward_pairs(ws, x, res, dout, seg, fault=None) -> dict:
    """Kernel 13 with seg through the training path's op (autograd through
    fused_dense_block_train, `fault` planted) against autograd of the
    plain seg form in f32 with lrelu' pinned to the kernel's own y
    (check_dense_backward's reason): value, dx, each dW and db, dres."""
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt

    g = ws[0][0].shape[-1]
    y = torch.empty((*x.shape[:3], 4 * g), dtype=x.dtype, device=x.device)
    dt.fused_dense_block(x, ws, workspace=y, seg=seg)
    slopes = torch.where(y.float() > 0, 1.0, 0.2)
    kin = [t.detach().requires_grad_()
           for t in [x, *(t for pair in ws for t in pair), res]]
    kseg, bit = seg_fault(fault, seg)
    with seg_planted(bit):
        yk = dtt.fused_dense_block_train(
            kin[0], list(zip(kin[1:11:2], kin[2:11:2])), kin[-1], seg=kseg)
        got = torch.autograd.grad(yk, kin, dout)
    leaves = [t.detach().float().requires_grad_() for t in kin]
    out = pinned_dense_block(leaves[0], list(zip(leaves[1:11:2],
                                                 leaves[2:11:2])),
                             leaves[-1], slopes, seg)
    ref = torch.autograd.grad(out, leaves, dout.float())
    pairs = {"value": (yk.detach(), out.detach(), TOL_KERNEL),
             "dx": (got[0], ref[0], TOL_KERNEL)}
    for j in range(5):
        pairs[f"dW{j + 1}"] = (got[1 + 2 * j], ref[1 + 2 * j], TOL_DW)
        pairs[f"db{j + 1}"] = (got[2 + 2 * j], ref[2 + 2 * j], TOL_DW)
    pairs["dres"] = (got[-1], ref[-1], 0.0)
    return pairs


def judge_pairs(name: str, pairs: dict, fault: str | None = None) -> dict:
    """Without a fault, each pair within its bar (the worst line back);
    with one, raise unless some pair misses by TOL_PLANT_FACTOR times its
    bar (non-finite values count as caught)."""
    if fault is None:
        return max((compare(f"{name}/{k}", g, r, tol)
                    for k, (g, r, tol) in pairs.items()),
                   key=lambda e: e["max_rel_err"] / max(e["tol"], 1e-9))
    worst, at = 0.0, None
    for k, (g, r, tol) in pairs.items():
        if tol == 0.0:
            continue
        finite = bool(torch.isfinite(g.float()).all())
        ratio = rel_err(g, r) / tol if finite else float("inf")
        if ratio > worst:
            worst, at = ratio, k
    emit({"planted_fault": f"{name}/{fault}", "worst_check": at,
          "bars_missed_by": worst, "caught": worst > TOL_PLANT_FACTOR})
    if not worst > TOL_PLANT_FACTOR:
        raise AssertionError(f"{name}: planted fault {fault} shows only "
                             f"{worst} x its bar")
    return {}


def check_seg_kernels(gen: torch.Generator) -> dict:
    """Phase 31: B1 and kernel 13 with seg at esrgan_x4_tiled's packed
    geometry [1, 8*49, 48, 64] (the RRDB residual folded, as in each
    RRDB's third block) against their plain seg forms; spacer rows of the
    value and of dx exactly 0; the three SEG_FAULTS each caught by 3x the
    bar; timed packed, per image ([8,48,48,64], no seg) and plain."""
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt
    from superresolution_tpu_torch.train.fused_apply import pack_batch_rows

    t0 = time.perf_counter()
    bf = torch.bfloat16
    b, h, w, c, g = SEG_IMAGES, SEG_LR, SEG_LR, 64, 32
    seg = (h + 1, h)
    ws = dense_check_weights(gen, c, g)
    x8 = rand(gen, b, h, w, c, scale=0.2, dtype=bf)
    res8 = rand(gen, b, h, w, c, scale=0.05, dtype=bf)
    dout8 = rand(gen, b, h, w, c, dtype=bf)
    xp, resp = pack_batch_rows(x8), pack_batch_rows(res8)
    # the cotangent is nonzero on the spacer rows too: the kernels must
    # ignore it there
    doutp = rand(gen, 1, b * (h + 1), w, c, dtype=bf)
    fwd = seg_forward_pairs(ws, xp, resp, seg)
    e1 = judge_pairs("fused_dense_block_seg", fwd)
    spacer_rows_zero("fused_dense_block_seg/value", fwd["value"][0], seg)
    bwd = seg_backward_pairs(ws, xp, resp, doutp, seg)
    e13 = judge_pairs("dense_block_backward_seg", bwd)
    spacer_rows_zero("dense_block_backward_seg/value", bwd["value"][0], seg)
    spacer_rows_zero("dense_block_backward_seg/dx", bwd["dx"][0], seg)
    for fault in SEG_FAULTS:
        judge_pairs("fused_dense_block_seg",
                    seg_forward_pairs(ws, xp, resp, seg, fault), fault)
        judge_pairs("dense_block_backward_seg",
                    seg_backward_pairs(ws, xp, resp, doutp, seg, fault),
                    fault)

    px = b * h * w                       # image pixels: the work
    packed_bytes = xp.numel() * 2
    flat = [t for pair in ws for t in pair]
    leaves = [xp.detach().requires_grad_()] + [
        t.detach().requires_grad_() for t in flat]
    wsl = list(zip(leaves[1::2], leaves[2::2]))

    def plain13():
        y = dt.fused_dense_block_reference(leaves[0], wsl, seg=seg)
        return torch.autograd.grad(y, leaves, doutp)

    b1, by1 = bound(2 * px * B1_MACS, 3 * packed_bytes + 2 * B1_MACS
                    + 4 * 192)
    b13, by13 = bound(2 * px * (2 * B1_MACS + RECOMPUTE_MACS),
                      3 * packed_bytes + 4 * B1_MACS + 8 * (4 * g + c))
    out = {
        "fused_dense_block_seg": {
            "name": "fused_dense_block_seg", "route": "cuda",
            "source": DENSE_SRC, "sources": [DENSE_SRC, ENGINE_SRC],
            "replaces": "superresolution_tpu/ops/pallas_dense_trunk.py:237",
            "shape": list(xp.shape), "seg": list(seg),
            "max_abs_err": e1["max_abs_err"],
            "max_rel_err": e1["max_rel_err"], "tol": TOL_KERNEL,
            "ms": time_ms(lambda: dt.fused_dense_block(xp, ws, resp,
                                                       seg=seg), 20),
            "per_image_ms": time_ms(
                lambda: dt.fused_dense_block(x8, ws, res8), 20),
            "plain_ms": time_ms(lambda: dt.fused_dense_block_reference(
                xp, ws, resp, seg=seg), 20),
            "bound_ms": b1, "bound_by": by1, "library_ms": None},
        "dense_block_backward_seg": {
            "name": "dense_block_backward_seg", "route": "cuda",
            "source": TRAIN_TC_SRC,
            "sources": [TRAIN_TC_SRC, TRAIN_SRC, DENSE_SRC, ENGINE_SRC],
            "replaces": "superresolution_tpu/ops/pallas_dense_trunk_vjp.py:386",
            "shape": list(xp.shape), "seg": list(seg),
            "max_abs_err": e13["max_abs_err"],
            "max_rel_err": e13["max_rel_err"], "tol": e13["tol"],
            "ms": time_ms(lambda: dtt.dense_block_backward(
                xp, ws, resp, doutp, seg), 10),
            "per_image_ms": time_ms(lambda: dtt.dense_block_backward(
                x8, ws, res8, dout8), 10),
            "plain_ms": time_ms(plain13, 10),
            "bound_ms": b13, "bound_by": by13, "library_ms": None,
            "parent_kernel": OLD_KERNELS["dense_block_backward_seg"][0],
            "device_ms": backward_split(lambda: dtt.dense_block_backward(
                xp, ws, resp, doutp, seg))["device_ms"]}}
    with k13_direct():
        out["dense_block_backward_seg"].update(
            parent_kernel_ms=time_ms(lambda: dtt.dense_block_backward(
                xp, ws, resp, doutp, seg), 10),
            parent_kernel_device_ms=backward_split(
                lambda: dtt.dense_block_backward(
                    xp, ws, resp, doutp, seg))["device_ms"])
    for row in out.values():
        emit({"phase": "kernel_time", **row})
    kernel, ms, row = OLD_KERNELS["dense_block_backward_seg"]
    old_kernel("dense_block_backward_seg", kernel, list(xp.shape), ms, row)
    emit({"phase": "seg_kernels", "seconds": time.perf_counter() - t0})
    return out


def preset_trainer(name: str, workdir: str, **train):
    """The preset at its own widths and data settings, cut in length to
    PRESET_STEPS[name] steps over a synthetic set of that many batches,
    one eval at the end; `train` overrides TrainConfig fields."""
    import dataclasses
    import shutil

    from superresolution_tpu_torch.train.trainer import Trainer
    from superresolution_tpu_torch.utils.config import get_preset

    cfg = get_preset(name)
    steps = PRESET_STEPS[name]
    data = dataclasses.replace(
        cfg.data, synthetic_len=steps * cfg.data.batch_size, num_workers=4)
    tc = dict(epochs=1, steps_per_epoch=steps, eval_every=1, resume=False)
    tc.update(train)
    shutil.rmtree(workdir, ignore_errors=True)
    return Trainer(cfg.replace(data=data, train=dataclasses.replace(
        cfg.train, **tc)), workdir)


def fit_counted(tr, expected: dict, tag: str) -> dict:
    """tr.fit() with every kernel's count (and B1's and kernel 13's seg
    counts) set to 0 just before and read just after, held to
    `expected` (names not in it: 0)."""
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_trunk_train as dtt

    ops = zero_counts()
    dt.fused_dense_block.seg_launches = 0
    dtt.dense_block_backward.seg_launches = 0
    t0 = time.perf_counter()
    out = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: op.launches for k, op in ops.items()}
    launches["fused_dense_block_seg"] = dt.fused_dense_block.seg_launches
    launches["dense_block_backward_seg"] = (
        dtt.dense_block_backward.seg_launches)
    check_launches(tag, launches, {k: expected.get(k, 0) for k in launches})
    with open(f"{tr.workdir}/logs/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    log = next(r for r in recs if "train/total" in r)
    vals = [log["train/total"], log["train/grad_norm"], out["best"]["psnr"]]
    if not all(np.isfinite(vals)):
        raise AssertionError(f"{tag}: non-finite loss, grad norm or PSNR "
                             f"{vals}")
    return {"fit_s": fit_s, "steps": out["final_step"],
            "launches": {k: v for k, v in launches.items() if v},
            "train_loss": log["train/total"],
            "grad_norm": log["train/grad_norm"],
            "val_psnr": out["best"]["psnr"]}


def step_ms(step, state, batch, runs: int = TIME_STEPS) -> float:
    """Host ms per call of step(state, batch, None) after one warm-up."""
    step(state, batch, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        step(state, batch, None)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs * 1e3


def packed_train_path(card: str) -> dict:
    """Phase 32: esrgan_x4_tiled (23 RRDBs x 64, growth 32, batch 8, hr
    192, bicubic, bf16) trains 3 steps row-packed through B1 and kernel
    13 with seg (fused_trunk=True), launches exact; then once with
    fused_trunk=None under SRTPU_PACKED_TRAIN (and off without it); one
    step against the plain f32 step; ms/step packed, per image and
    plain, and a profiled step's busy share. Returns the launches of the
    3-step fit."""
    from superresolution_tpu_torch.data.loader import prefetch_to_device
    from superresolution_tpu_torch.train.fused_apply import (
        make_fused_train_apply)
    from superresolution_tpu_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    wd = f"{DEFAULTS_DIR}/esrgan_x4_tiled"
    steps = PRESET_STEPS["esrgan_x4_tiled"]
    with preset_trainer("esrgan_x4_tiled", wd, fused_trunk=True) as tr:
        if tr.fused_apply is None or tr.batch_size != SEG_IMAGES:
            raise AssertionError("esrgan_x4_tiled: no fused apply or batch "
                                 f"{tr.batch_size}")
        nb = tr.model.num_blocks
        per_step = {"fused_dense_block": 3 * nb * 9,
                    "dense_block_backward": 3 * nb}
        per_step.update(
            fused_dense_block_seg=per_step["fused_dense_block"],
            dense_block_backward_seg=per_step["dense_block_backward"])
        res = fit_counted(tr, {k: steps * v for k, v in per_step.items()},
                          "esrgan_x4_tiled")
        emit({"phase": "packed_train", **res})
        # one fixed batch: the first training batch, degraded, no
        # augmentation
        lr, hr = tr.eval_input_fn(
            next(iter(prefetch_to_device(tr.train_loader))), None)
        # held against the plain step in f32: at 23 RRDBs the plain bf16
        # step's own roundings put its first RRDB's gradients 0.039 of
        # max from f32 (an H100 80GB HBM3 at 700 W), farther than the
        # packed kernel path's 0.013, so it cannot be the reference at
        # the 0.03 bar; the bf16 distances are printed beside
        check_train_step(tr, lr, hr, "esrgan_x4_tiled_packed", prefixes=(
            "conv_first.", "body.0.", f"body.{nb // 2}.", f"body.{nb - 1}.",
            "conv_body.", "conv_hr."), against="f32")
        dev_batch = {"lr": lr, "hr": hr}
        per_image = make_train_step(
            tr.model, tr.loss_fn, tr.tx, tr.policy, tr.eval_input_fn,
            apply_fn=make_fused_train_apply(tr.model, row_pack=False))
        plain = make_train_step(tr.model, tr.loss_fn, tr.tx, tr.policy,
                                tr.eval_input_fn)
        packed = make_train_step(tr.model, tr.loss_fn, tr.tx, tr.policy,
                                 tr.eval_input_fn, apply_fn=tr.fused_apply)
        times = {"packed_ms_per_step": step_ms(packed, tr.state, dev_batch),
                 "per_image_ms_per_step": step_ms(per_image, tr.state,
                                                  dev_batch),
                 "plain_ms_per_step": step_ms(plain, tr.state, dev_batch)}
        prof = frame_profile(lambda: packed(tr.state, dev_batch, None))
        prof1 = frame_profile(lambda: per_image(tr.state, dev_batch, None))
        emit({"phase": "packed_train_times", "card": card,
              "batch": SEG_IMAGES, "lr_patch": SEG_LR, **times,
              "profiled_step_s": prof["profiled_frame_s"],
              "device_ms_per_step": prof["device_ms_per_frame"],
              "device_busy_share": prof["device_busy_share"],
              "per_image_device_ms_per_step": prof1["device_ms_per_frame"],
              "per_image_busy_share": prof1["device_busy_share"],
              "top_device_kernels": prof["top_device_kernels"][:6],
              "per_image_top_device_kernels":
                  prof1["top_device_kernels"][:4]})
    old = os.environ.pop("SRTPU_PACKED_TRAIN", None)
    try:
        with preset_trainer("esrgan_x4_tiled", wd, fused_trunk=None,
                            steps_per_epoch=1) as tr:
            if tr.fused_apply is not None:
                raise AssertionError("fused_trunk=None packed without "
                                     "SRTPU_PACKED_TRAIN")
        os.environ["SRTPU_PACKED_TRAIN"] = "1"
        with preset_trainer("esrgan_x4_tiled", wd, fused_trunk=None,
                            steps_per_epoch=1) as tr:
            if tr.fused_apply is None:
                raise AssertionError("SRTPU_PACKED_TRAIN did not turn the "
                                     "packed apply on")
            env = fit_counted(tr, per_step, "esrgan_x4_tiled/env")
    finally:
        if old is None:
            os.environ.pop("SRTPU_PACKED_TRAIN", None)
        else:
            os.environ["SRTPU_PACKED_TRAIN"] = old
    emit({"phase": "packed_train_env", "launches": env["launches"],
          "seconds": time.perf_counter() - t_phase})
    return res["launches"]


def degradation_on_card(gen: torch.Generator) -> None:
    """blur_bicubic and bsr_light LR made on the card against the CPU from
    the same fixed draws (sigma, noise sigma, quality, noise field): f32
    within TOL_DEGRADE; for bsr_light, at most TOL_JPEG_SHARE of the
    pixels past it."""
    from superresolution_tpu_torch.ops.degradation import (
        degrade_with_draws, draw_degradation)

    hr = torch.rand((4, 192, 192, 3), generator=gen)
    dr = draw_degradation(gen, 4)
    noise = torch.randn((4, 48, 48, 3), generator=gen)
    for mode in ("blur_bicubic", "bsr_light"):
        args = (dr["sigma"], dr["noise_sigma"], dr["quality"], noise)
        cpu = degrade_with_draws(hr, 4, mode, *args)
        card = degrade_with_draws(hr.cuda(), 4, mode,
                                  *(a.cuda() for a in args)).cpu()
        d = (card - cpu).abs()
        share = float((d > TOL_DEGRADE).float().mean())
        emit({"check": f"degradation/{mode}/card_vs_cpu",
              "max_abs_err": float(d.max()), "share_past_tol": share,
              "tol": TOL_DEGRADE, "draws": {k: v.tolist()
                                            for k, v in dr.items()}})
        limit = 0.0 if mode == "blur_bicubic" else TOL_JPEG_SHARE
        if share > limit:
            raise AssertionError(f"degradation {mode}: {share} of the "
                                 f"pixels past {TOL_DEGRADE}")


def bicubic_presets_path(gen: torch.Generator, card: str) -> int:
    """Phase 33: edsr_baseline_x4 at full width (16 x 64, hr 192, batch
    16, bicubic) for 3 steps with eval_every=1 and preview_every=1: a
    preview PNG a step, async checkpoints, kernel 15 launches exact;
    finalize(probe=params_probe(...)), load_params_for_inference of the
    promoted weights against the module restored to the best step
    (restore_best), equal on a patch; then srcnn_x2 (fp32), espcn_x4
    and fsrcnn_x4 for 2 steps each; ms/step for each; the degradation
    modes on the card against the CPU. Returns kernel 15's launches."""
    from superresolution_tpu_torch.data.loader import prefetch_to_device
    from superresolution_tpu_torch.models.factory import build_from_config
    from superresolution_tpu_torch.train.checkpoint import (
        load_params_for_inference, params_probe)
    from superresolution_tpu_torch.utils.config import ModelConfig

    t_phase = time.perf_counter()
    k15 = 0
    times = {}
    wd = f"{DEFAULTS_DIR}/edsr_baseline_x4"
    with preset_trainer("edsr_baseline_x4", wd, epochs=3, steps_per_epoch=1,
                        preview_every=1) as tr:
        per_fwd = 2                   # two x2 upsampler stages
        want = 3 * per_fwd * (1 + len(tr.val_loader) + 1)
        res = fit_counted(tr, {"conv3x3_depth_to_space": want},
                          "edsr_baseline_x4")
        res["kernel15_bodies"] = expect_tc_body(
            "edsr_baseline_x4", counted_ops()["conv3x3_depth_to_space"])
        k15 += want
        previews = sorted(os.listdir(f"{wd}/previews"))
        if previews != [f"epoch_{e:05d}.png" for e in (1, 2, 3)]:
            raise AssertionError(f"edsr previews {previews}")
        meta = json.load(open(f"{wd}/checkpoints/meta.json"))
        if meta["last_step"] != 3 or not os.path.exists(
                f"{wd}/checkpoints/step_{3:010d}/state.pt"):
            raise AssertionError(f"edsr checkpoints {meta}")
        key = "params/" + next(iter(tr.state.params))
        best_dir = tr.finalize(probe=params_probe(key))
        try:
            params_probe("params/no_such.weight")(best_dir)
        except KeyError:
            pass
        else:
            raise AssertionError("params_probe passed a missing key")
        params, cfg = load_params_for_inference(best_dir, with_config=True)
        cfg.pop("output_size", None)
        loaded = build_from_config(ModelConfig(**cfg))
        loaded.load_state_dict(params)
        restored = tr.ckpt.restore_best(tr.state)
        best_model = build_from_config(ModelConfig(**cfg))
        best_model.load_state_dict(restored.params)
        x = torch.rand((1, 48, 48, 3), generator=gen).cuda()
        with torch.inference_mode():
            same = bool(torch.equal(loaded(x), best_model(x)))
            same_trained = bool(torch.equal(loaded(x), tr.model(x)))
        emit({"check": "edsr_baseline_x4/finalize_load", "probe": key,
              "best_step": meta["best_step"], "last_step": 3,
              "equal_to_best": same, "equal_to_trained": same_trained})
        if not same or (meta["best_step"] == 3 and not same_trained):
            raise AssertionError("the promoted weights do not give the "
                                 "best step's output")
        batch = next(iter(prefetch_to_device(tr.train_loader)))
        times["edsr_baseline_x4"] = step_ms(tr._train_step, tr.state, batch)
        emit({"phase": "edsr_train", **res, "previews": previews,
              "ms_per_step": times["edsr_baseline_x4"]})
    for name, per_fwd in (("srcnn_x2", 0), ("espcn_x4", 1),
                          ("fsrcnn_x4", 0)):
        with preset_trainer(name, f"{DEFAULTS_DIR}/{name}") as tr:
            want = per_fwd * (PRESET_STEPS[name] + len(tr.val_loader))
            res = fit_counted(tr, {"conv3x3_depth_to_space": want}, name)
            if want:
                res["kernel15_bodies"] = expect_tc_body(
                    name, counted_ops()["conv3x3_depth_to_space"])
            k15 += want
            batch = next(iter(prefetch_to_device(tr.train_loader)))
            times[name] = step_ms(tr._train_step, tr.state, batch)
            emit({"phase": f"{name}_train", **res,
                  "ms_per_step": times[name]})
    degradation_on_card(gen)
    emit({"phase": "bicubic_presets", "card": card, "ms_per_step": times,
          "seconds": time.perf_counter() - t_phase})
    return k15


def manifest_path(gen: torch.Generator, card: str) -> dict:
    """Phase 34: 8 co-registered 128^2 / 512^2 16-bit TIFF pairs
    (SyntheticHRDataset with lr_scale 4) and a train/val/test manifest
    (prepare_splits); hybrid_astro at full width (batch 4, degradation
    'none', star L1) trains 2 steps from it with a preview due, launches
    exact (B1, kernels 13 and 14); the native decoder must have served
    batches; run_test(labeled=True) writes its TIFFs, labelled strips and
    metrics.txt. Returns the fit's launches."""
    import dataclasses
    import shutil

    from superresolution_tpu_torch.data import native_io
    from superresolution_tpu_torch.data.dataset import SyntheticHRDataset
    from superresolution_tpu_torch.data.io import save_tiff16
    from superresolution_tpu_torch.data.manifest import prepare_splits
    from superresolution_tpu_torch.infer.evaluate import run_test
    from superresolution_tpu_torch.train.trainer import Trainer
    from superresolution_tpu_torch.utils.config import get_preset

    t_phase = time.perf_counter()
    shutil.rmtree(MANIFEST_DIR, ignore_errors=True)
    root = f"{MANIFEST_DIR}/pairs"
    ds = SyntheticHRDataset(8, 512, 1, seed=3, lr_scale=4)
    for i in range(len(ds)):
        item = ds[i]
        save_tiff16(item["hr"], f"{root}/pair_{i:04d}/hubble.tiff")
        save_tiff16(item["lr"], f"{root}/pair_{i:04d}/observatory.tiff")
    splits = prepare_splits(root, f"{MANIFEST_DIR}/splits")
    cfg = get_preset("hybrid_astro")
    data = dataclasses.replace(
        cfg.data, train_manifest=splits["train"],
        val_manifest=splits["val"], test_manifest=splits["test"],
        num_workers=4)
    train = dataclasses.replace(cfg.train, epochs=2, steps_per_epoch=1,
                                eval_every=1, preview_every=2, resume=False)
    if native_io.get_lib() is None:
        raise AssertionError("the native TIFF decoder did not build")
    native_io.decode_batch.batches = 0
    wd = f"{MANIFEST_DIR}/train"
    with Trainer(cfg.replace(data=data, train=train), wd) as tr:
        nb = tr.model.stage1.num_blocks
        per_step = {"fused_dense_block": 3 * nb * 9,
                    "dense_block_backward": 3 * nb,
                    "star_weighted_l1_cuda": 2}
        res = fit_counted(tr, {k: 2 * v for k, v in per_step.items()},
                          "hybrid_astro/manifest")
        served = native_io.decode_batch.batches
        if served == 0:
            raise AssertionError("the native decoder served no batch")
        if not os.path.exists(f"{wd}/previews/epoch_00002.png"):
            raise AssertionError("no preview at epoch 2")
        test = run_test(tr, labeled=True)
        files = sorted(os.listdir(f"{wd}/test_results"))
        n_test = len(tr.test_ds)
        want = sorted([f"result_{i:04d}.tiff" for i in range(n_test)]
                      + [f"comparison_{i:04d}.png" for i in range(n_test)]
                      + ["metrics.txt"])
        if files != want or not np.isfinite(test["psnr"]):
            raise AssertionError(f"run_test wrote {files}, {test}")
    emit({"phase": "manifest_train", "card": card, **res,
          "native_batches": served, "splits": {
              k: len(json.load(open(v))) for k, v in splits.items()},
          "test": test, "test_files": files,
          "seconds": time.perf_counter() - t_phase})
    return res["launches"]


# ---- 35-38: the last TPU kernels outside benchmarks/, kernels 16-19 ----
# No path of the system runs them: each phase drives the kernel's own
# public entry point at the full shape of the layer it stands for.

EXTRA_SRC = "superresolution_tpu_torch/ops/csrc/extra_kernels.cu"
DENSE_VALID_SRC = "superresolution_tpu_torch/ops/csrc/dense_valid_kernels.cu"
# kernel 16's first form (extra_kernels.cu conv_kernel<DenseStage<bf16>>,
# f32 FFMA on the CUDA cores; the direct body still serves f32 and the
# shapes off the route rule) in bf16 at TRUNK_TILE, timed on the tree
# before the tensor-core route (PERF.md row 16)
K16_OLD = "extra_kernels.cu conv_kernel<DenseStage<bf16>>, CUDA cores"
K16_OLD_MS = 55.7485
PACK_SRC = "superresolution_tpu_torch/ops/csrc/pack_kernels.cu"
TOL_F32 = 1e-4            # kernels 16 and 18 in f32 against plain f32
TOL_BLUR = 0.01           # kernel 17 in bf16: f32 sums rounded once
TOL_BLUR_F32 = 1e-5
TRUNK_TILE = (24, TILE[0] + 2 * HALO, TILE[1] + 2 * HALO)  # B1's timed tile
BLUR_CASES = (("hybrid_256_balanced", (4, 256, 256, 1), "balanced"),
              ("hybrid_512_balanced", (4, 512, 512, 1), "balanced"),
              ("hybrid_512_light", (4, 512, 512, 1), "light"),
              ("c64_strong", (8, 128, 128, 64), "strong"))
# the kernel's other tap forms: scalar taps (C 3), two channel chunks
# with scalar taps (C 130) and with vector taps and stores, the last chunk
# part padding (C 96); checked, not timed
BLUR_EXTRA = (("ragged_c3_balanced", (2, 37, 45, 3), "balanced"),
              ("chunked_c130_strong", (1, 33, 20, 130), "strong"),
              ("chunked_c96_strong", (1, 33, 20, 96), "strong"))
# The kernel 17 replaced (one thread per output value, its k^2 taps
# through L1) at BLUR_CASES, as PERF.md's kernel table keeps it (row 17).
# Printed as a reference, not re-run.
BLUR_OLD = "extra_kernels.cu blur_kernel, one thread per output value"
BLUR_OLD_MS = {"hybrid_256_balanced": 0.0241, "hybrid_512_balanced": 0.0378,
               "hybrid_512_light": 0.0225, "c64_strong": 0.449}
PACK_CONVS = ((64, 192), (32, 160), (32, 128), (32, 96), (32, 64))
PACK_P = 2                # W2 = 144 packs at the tile's 256 columns


def entry_path(name: str, fn, want: int):
    """fn(), the op `name`'s entry point, with every counted kernel's
    count set to 0 just before and read just after: `name` launched
    exactly `want` times and every other kernel none. Returns fn()'s
    result."""
    ops = zero_counts()
    y = fn()
    torch.cuda.synchronize()
    launches = {k: op.launches for k, op in ops.items()}
    check_launches(name, launches, {**{k: 0 for k in ops}, name: want},
                   system=False)
    emit({"phase": "entry_path", "op": name, "launches": want})
    return y


def border(t: torch.Tensor, k: int = 5) -> torch.Tensor:
    """The values of NHWC t within k px of the image's border."""
    h, w = t.shape[1:3]
    keep = torch.ones((h, w), dtype=torch.bool, device=t.device)
    keep[k:h - k, k:w - k] = False
    return t[:, keep]


def check_dense_valid_kernel(gen: torch.Generator) -> dict:
    """Phase 35: kernel 16 (fused_dense_block_valid) at B1's timed tile
    [24,376,256,64], c 64, g 32, on B1's check weights (dense_check_weights,
    MSRA x 2) mapped to the projection matrices by models/convert.
    _fuse_dense, the stages' K-major weights packed once
    (pack_stage_weights). bf16 on the tensor-core body: 5 launches there
    and 0 direct, within 0.02 of the plain form in f32 (TF32 off) on the
    same values over the whole image and over the 5-px border alone; the
    interior [5:-5, 5:-5] within 0.02 of B1 on the same weights, the
    border's distance from B1 printed. Two faults planted in the
    tensor-core body must miss by 3x the bar: the intermediates zeroed
    outside the image (SAME semantics, judged on the border) and the 0.2
    residual scale dropped. f32 within 1e-4 on the direct body (5 direct
    launches); a bf16 shape off the route rule (c 36, g 12, ragged) within
    0.02 on the direct body. Timed beside B1, the plain form, the packing
    alone, a call that packs, and the direct body in bf16 at the same
    shape through its launch helper (the first form, K16_OLD_MS printed).
    Returns the kernels-line entry."""
    from superresolution_tpu_torch.models.convert import _fuse_dense
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import dense_trunk as dt
    from superresolution_tpu_torch.ops import dense_valid as dv

    bf = torch.bfloat16
    op = dv.fused_dense_block_valid

    def matrices(gen, c, g):
        ws = dense_check_weights(gen, c, g)
        tree = _fuse_dense([k.float().cpu().numpy() for k, _ in ws],
                           [bb.cpu().numpy() for _, bb in ws], c, g)
        *wm, bias = [torch.from_numpy(m).cuda()
                     for m in dv.pack_fused_weights(tree, c, g)]
        return ws, wm, bias

    def on_body(tag, fn, body):
        zero_counts()
        y = fn()
        torch.cuda.synchronize()
        got = (op.launches, op.tc_launches, op.direct_launches)
        want = (5, 5 * (body == "tc"), 5 * (body == "direct"))
        emit({"check": f"fused_dense_block_valid/{tag}/bodies",
              "launches": got[0], "tc_launches": got[1],
              "direct_launches": got[2]})
        if got != want:
            raise AssertionError(f"fused_dense_block_valid/{tag}: launches "
                                 f"{got} != {want} ({body} body)")
        return y

    # a bf16 shape off the route rule, on the direct body (its own
    # generator, so the phases after this one draw what they drew before)
    og = torch.Generator().manual_seed(SEED + 13)
    c, g = 36, 12
    _, wm, bias = matrices(og, c, g)
    xs = rand(og, 2, 40, 45, c, scale=0.2).to(bf)
    if dt.uses_tensor_cores(xs, c, g):
        raise AssertionError("fused_dense_block_valid: c 36, g 12 on the "
                             "route rule")
    with torch.inference_mode():
        got = on_body("off_rule_c36_g12", lambda: dv.fused_dense_block_valid(
            xs, *wm, bias), "direct")
        compare("fused_dense_block_valid/off_rule_c36_g12/bf16/direct", got,
                dv.fused_dense_block_valid_reference(
                    xs.float(), *[m.to(bf).float() for m in wm], bias),
                TOL_KERNEL)
    del xs, got

    c, g = 64, 32
    b, h, w = TRUNK_TILE
    ws, wm, bias = matrices(gen, c, g)
    wmb = [m.to(bf) for m in wm]
    stages = dv.pack_stage_weights(*wmb)
    x32 = rand(gen, b, h, w, c, scale=0.2)
    xb = x32.to(bf)
    if not dt.uses_tensor_cores(xb, c, g):
        raise AssertionError("fused_dense_block_valid: bf16 c 64, g 32 off "
                             "the route rule")

    def kern(x=xb):
        return dv.fused_dense_block_valid(
            x, *wm, bias, stages=stages if x.dtype == bf else None)

    with torch.inference_mode():
        got = entry_path("fused_dense_block_valid", kern, 5)
        emit({"check": "fused_dense_block_valid/bf16/bodies",
              **by_body(op)})
        if op.tc_launches != 5 or op.direct_launches:
            raise AssertionError(f"fused_dense_block_valid: bf16 not on the "
                                 f"tensor cores: {by_body(op)}")
        ref = dv.fused_dense_block_valid_reference(
            xb.float(), *[m.float() for m in wmb], bias)
        err = compare("fused_dense_block_valid/bf16", got, ref, TOL_KERNEL,
                      plain_bf16_rel_err=rel_err(
                          dv.fused_dense_block_valid_reference(xb, *wm, bias),
                          ref))
        compare("fused_dense_block_valid/bf16/border", border(got),
                border(ref), TOL_KERNEL)
        b1 = dt.fused_dense_block(xb, ws)
        gap = rel_err(border(got), border(b1))
        compare("fused_dense_block_valid/interior_vs_B1",
                got[:, 5:-5, 5:-5], b1[:, 5:-5, 5:-5], TOL_KERNEL,
                border_rel_err_vs_B1=gap)
        del b1, got
        for bit, fault, judge in (
                (_build.PLANT_SAME, "same_padding", border),
                (_build.PLANT_NO_SCALE, "residual_scale_dropped",
                 lambda t: t)):
            bad = planted("dense_valid_tc", bit, kern)
            if bit == _build.PLANT_SAME:
                emit({"planted_fault": fault, "interior_rel_err": rel_err(
                    bad[:, 5:-5, 5:-5], ref[:, 5:-5, 5:-5])})
            expect_margin(f"fused_dense_block_valid:tc:{fault}", judge(bad),
                          judge(ref), TOL_KERNEL)
            del bad
        # the direct body in bf16 at the same shape, through its helper
        wsb = torch.empty((b, h + 8, w + 8, 4 * g), dtype=bf, device="cuda")
        out = torch.empty_like(xb)

        def direct():
            for j in range(1, 6):
                _build.dense_valid_stage(xb, wsb, out, wmb, bias, j)

        direct()
        d_err = compare("fused_dense_block_valid/bf16/direct", out, ref,
                        TOL_KERNEL)
        del ref
        torch.cuda.empty_cache()
        got = on_body("f32", lambda: kern(x32), "direct")
        compare("fused_dense_block_valid/f32", got, dv.
                fused_dense_block_valid_reference(x32, *wm, bias), TOL_F32)
        del got, x32
        torch.cuda.empty_cache()
        macs = b * sum((h + 10 - 2 * j) * (w + 10 - 2 * j) * 9
                       * (c + (j - 1) * g) * (g if j < 5 else c)
                       for j in range(1, 6))
        b_ms, b_by = bound(2 * macs, 2 * xb.numel() * 2
                           + sum(m.numel() for m in wm) * 2 + bias.numel() * 4)
        entry = {
            "name": "fused_dense_block_valid", "route": "cuda",
            "source": DENSE_VALID_SRC, "sources": [DENSE_VALID_SRC,
                                                   ENGINE_SRC],
            "replaces": "superresolution_tpu/ops/pallas_dense.py:135",
            "shape": [b, h, w, c], "max_abs_err": err["max_abs_err"],
            "max_rel_err": err["max_rel_err"], "tol": TOL_KERNEL,
            "ms": time_ms(kern, 5),
            "plain_ms": time_ms(
                lambda: dv.fused_dense_block_valid_reference(xb, *wm, bias),
                5),
            "b1_ms": time_ms(lambda: dt.fused_dense_block(xb, ws), 5),
            "packing_ms": time_ms(lambda: dv.pack_stage_weights(*wmb), 5),
            "packing_each_call_ms": time_ms(
                lambda: dv.fused_dense_block_valid(xb, *wm, bias), 5),
            "direct_bf16_ms": time_ms(direct, 3),
            "direct_bf16_max_rel_err": d_err["max_rel_err"],
            "first_form_ms": K16_OLD_MS,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches": 5, "tc_launches": 5, "direct_launches": 0,
            "path": "its entry point; no path of the system calls it"}
        entry["share_of_bound"] = b_ms / entry["ms"]
        old_kernel("fused_dense_block_valid", K16_OLD, [b, h, w, c],
                   K16_OLD_MS, "16")
        del out, wsb
    emit({"phase": "kernel_time", **entry})
    return entry


def blur_stays_inside(tag: str, x: torch.Tensor, size: int,
                      norm: float) -> None:
    """Kernel 17 launched into the head of a NaN-filled buffer twice x's
    size: it writes every value of its output and nothing after it."""
    from superresolution_tpu_torch.ops import _build

    n = x.numel()
    buf = torch.full((2 * n,), float("nan"), dtype=x.dtype, device=x.device)
    _build.blur(x, size, norm, buf[:n].view(x.shape))
    unwritten = int(buf[:n].isnan().sum())
    past = int((~buf[n:].isnan()).sum())
    emit({"check": f"anti_checkerboard_kernel/{tag}/stays_inside",
          "unwritten": unwritten, "written_past_end": past})
    if unwritten or past:
        raise AssertionError(f"kernel 17 at {tag}: {unwritten} values not "
                             f"written, {past} written past the output")


def check_blur_kernel(gen: torch.Generator) -> dict:
    """Phase 36: kernel 17 (anti_checkerboard_kernel) at hybrid_astro's
    blur shapes at batch 4 (256^2 and 512^2 balanced, 512^2 light) and
    [8,128,128,64] strong, on images in [0, 1): f32 within 1e-5 and bf16
    within 0.01 of the plain blur in f32 on the same values, writing
    nothing past its output (blur_stays_inside); the same at BLUR_EXTRA.
    Two faults planted in the kernel (normalized by the binomial row's
    sum, the top-left tap dropped) must miss by 3x the f32 bar at the
    256^2 and strong cases. Timed beside the plain blur and the
    depthwise F.conv2d alone: CUDA-event ms over 20 back-to-back calls
    (the wrappers' host work included) and torch.profiler device ms a
    call (launch_device_ms), for the kernel and F.conv2d; once, an empty
    kernel through the same ctypes path (the launch floor). Returns the
    kernels-line entry (512^2 balanced)."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import blur as bl

    bf = torch.bfloat16
    geometries = {}
    for tag, shape, mode in BLUR_CASES + BLUR_EXTRA:
        size, norm = bl._MODES[mode]
        x32 = torch.rand(shape, generator=gen).cuda()
        xb = x32.to(bf)

        def kern(x=xb, mode=mode):
            return bl.anti_checkerboard_kernel(x, mode)

        with torch.inference_mode():
            if tag == "hybrid_512_balanced":
                entry_path("anti_checkerboard_kernel", kern, 1)
            for xd, tol in ((x32, TOL_BLUR_F32), (xb, TOL_BLUR)):
                err = compare(f"anti_checkerboard_kernel/{tag}/{xd.dtype}",
                              kern(xd), bl.anti_checkerboard(xd.float(), mode),
                              tol)
                blur_stays_inside(f"{tag}/{xd.dtype}", xd, size, norm)
            if tag in ("hybrid_256_balanced", "c64_strong"):
                ref = bl.anti_checkerboard(x32, mode)
                for bit, fault in ((_build.PLANT_NORM, "row_sum_normalizer"),
                                   (_build.PLANT_CORNER, "corner_tap_dropped")):
                    expect_margin(f"anti_checkerboard_kernel:{tag}:{fault}",
                                  planted("blur", bit, lambda: kern(x32)),
                                  ref, TOL_BLUR_F32)
            if tag not in BLUR_OLD_MS:
                continue
            k = torch.as_tensor(bl.binomial_kernel(size, norm),
                                device="cuda").to(bf)
            kk = k.expand(shape[-1], 1, size, size)
            xn = xb.permute(0, 3, 1, 2)

            def lib():
                return F.conv2d(xn, kk, padding=size // 2, groups=shape[-1])

            n = xb.numel()
            b_ms, b_by = bound(2 * size * size * n, 2 * n * 2)
            geometries[tag] = {
                "shape": list(shape), "mode": mode,
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"],
                "ms": time_ms(kern, 20),
                "device_ms": launch_device_ms(kern),
                "plain_ms": time_ms(lambda: bl.anti_checkerboard(xb, mode),
                                    20),
                "library_ms": time_ms(lib, 20),
                "library_device_ms": launch_device_ms(lib),
                "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "kernel_time", "name": "anti_checkerboard_kernel",
              "geometry": tag, **geometries[tag]})
        old_kernel("anti_checkerboard_kernel", BLUR_OLD, list(shape),
                   BLUR_OLD_MS[tag], "17", geometry=tag)
    x = torch.empty(16, device="cuda")
    floor = {"noop_ms": time_ms(lambda: _build.noop(x), 20),
             "noop_device_ms": launch_device_ms(lambda: _build.noop(x))}
    emit({"phase": "kernel_time", "name": "launch_floor", **floor})
    main = geometries["hybrid_512_balanced"]
    return {"name": "anti_checkerboard_kernel", "route": "cuda",
            "source": EXTRA_SRC, "sources": [EXTRA_SRC, ENGINE_SRC],
            "replaces": "superresolution_tpu/ops/pallas_blur.py:50",
            **{k: main[k] for k in ("shape", "max_abs_err", "max_rel_err",
                                    "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "tol": TOL_BLUR, "launches": 1,
            "path": "its entry point; the hybrid's blur stays the plain "
                    "depthwise conv",
            "geometries": geometries, "launch_floor": floor,
            "ptxas": STENCIL_PTXAS.get("blur_kernel")}


def check_pack_conv_kernel(gen: torch.Generator) -> dict:
    """Phase 37: kernel 18 (pack_conv3x3) at the five convs of the dense
    block at B1's timed tile [24,376,256,c], p 2 (W2 144), in both bodies
    of the conv engine: bf16 (the tensor-core body, and the direct body
    through its launch helper) within 0.02 and f32 (the direct body)
    within 1e-4 of the plain form in f32 on the same values, every
    output pad pack exactly 0; the per-body counts show the route rule's
    pick; a chained lrelu pair (64 -> 192 -> 64) in bf16; the backward
    (dx, dw, db, f32) against autograd of the plain form within 1e-4.
    Two faults planted in the kernel (pad packs not zeroed, the left tap
    across a pack edge dropped) must miss by 3x the bar at 64 -> 192 in
    each body (bf16 tensor cores, f32 direct). Timed beside the direct
    body in bf16, the plain form and F.conv2d on the unpacked operands
    (cuDNN). Returns the kernels-line entry (64 -> 192)."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops import pairconv as pc

    bf = torch.bfloat16
    b, h, w = TRUNK_TILE
    p = PACK_P

    def pads_zero(name, y, n):
        full = y.reshape(y.shape[0], y.shape[1], -1, n)
        if full[:, :, :p].any() or full[:, :, p + w:].any():
            raise AssertionError(f"{name}: a pad pack is not 0")

    def weights(c, n):
        return ((torch.randn((3, 3, c, n), generator=gen)
                 / (9 * c) ** 0.5).cuda(),
                (0.5 * torch.randn(n, generator=gen)).cuda())

    geometries = {}
    for c, n in PACK_CONVS:
        tag = f"c{c}_n{n}"
        wt, bias = weights(c, n)
        x32 = rand(gen, b, h, w, c)
        with torch.inference_mode():
            xp32 = pc.pack_input(x32, p)
            xpb = xp32.to(bf)

            def kern(xp=xpb):
                return pc.pack_conv3x3(xp, wt, bias, p, w)

            def counted(fn, body):
                zero_counts()
                y = fn()
                if (pc.pack_conv3x3.launches != 1
                        or getattr(pc.pack_conv3x3, f"{body}_launches") != 1):
                    raise AssertionError(f"pack_conv3x3/{tag}: not one "
                                         f"counted {body} launch")
                return y

            if not pc.uses_tensor_cores(xpb, wt):
                raise AssertionError(f"pack_conv3x3/{tag}: bf16 not routed "
                                     "to the tensor cores")
            got = (entry_path("pack_conv3x3", kern, 1) if c == 64
                   else counted(kern, "tc"))
            if c == 64:
                expect_tc_body("pack_conv3x3", pc.pack_conv3x3)
            ref = pc.pack_conv3x3_reference(xpb.float(), wt.to(bf).float(),
                                            bias, p, w)
            err = compare(f"pack_conv3x3/{tag}/bf16/tc", got, ref, TOL_KERNEL)
            pads_zero(f"pack_conv3x3/{tag}/bf16/tc", got, n)
            faults = ((_build.PLANT_PAD_KEPT, "pads_not_zeroed"),
                      (_build.PLANT_DROP_CROSS, "cross_pack_tap_dropped"))
            for bit, fault in faults if c == 64 else ():
                expect_margin(f"pack_conv3x3:tc:{fault}",
                              planted("pack_conv", bit, kern), ref,
                              TOL_KERNEL)
            # the direct body in bf16, through its launch helper
            wk = pc.kmajor_weights(wt, bf)
            out = torch.empty_like(got)

            def direct():
                _build.pack_conv(xpb, wk, bias, out, p, w, False, False)

            direct()
            d_err = compare(f"pack_conv3x3/{tag}/bf16/direct", out, ref,
                            TOL_KERNEL)
            pads_zero(f"pack_conv3x3/{tag}/bf16/direct", out, n)
            del got, ref
            got = counted(lambda: kern(xp32), "direct")
            ref = pc.pack_conv3x3_reference(xp32, wt, bias, p, w)
            compare(f"pack_conv3x3/{tag}/f32/direct", got, ref, TOL_F32)
            pads_zero(f"pack_conv3x3/{tag}/f32/direct", got, n)
            for bit, fault in faults if c == 64 else ():
                expect_margin(f"pack_conv3x3:direct:{fault}",
                              planted("pack_conv", bit,
                                      lambda: kern(xp32)), ref, TOL_F32)
            del got, ref, xp32
            torch.cuda.empty_cache()
            xn = x32.to(bf).permute(0, 3, 1, 2)
            w_oihw = wt.to(bf).permute(3, 2, 0, 1).contiguous()
            b_lib = bias.to(bf)
            out_bytes = b * h * xpb.shape[2] * p * n * 2
            b_ms, b_by = bound(2 * b * h * w * 9 * c * n,
                               xpb.numel() * 2 + out_bytes + wt.numel() * 2
                               + n * 4)
            geometries[tag] = {
                "shape": list(xpb.shape), "c_in": c, "c_out": n, "p": p,
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"],
                "direct_max_rel_err": d_err["max_rel_err"],
                "ms": time_ms(kern, 5),
                "direct_ms": time_ms(direct, 2),
                "plain_ms": time_ms(lambda: pc.pack_conv3x3_reference(
                    xpb, wt, bias, p, w), 5),
                "library_ms": time_ms(lambda: F.conv2d(
                    xn, w_oihw, b_lib, padding=1), 5),
                "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "kernel_time", "name": "pack_conv3x3",
              "geometry": tag, **geometries[tag]})
        del x32, xpb, xn, out
        torch.cuda.empty_cache()

    # a chained lrelu pair: the pad packs the first writes are the zeros
    # the second reads
    (w1, b1), (w2, b2) = weights(64, 192), weights(192, 64)
    with torch.inference_mode():
        xpb = pc.pack_input(rand(gen, b, h, w, 64, dtype=bf), p)
        zero_counts()
        y = pc.pack_conv3x3(pc.pack_conv3x3(xpb, w1, b1, p, w, "lrelu"), w2,
                            b2, p, w)
        expect_tc_body("pack_conv3x3/chain_lrelu", pc.pack_conv3x3)
        y1 = pc.pack_conv3x3_reference(xpb.float(), w1.to(bf).float(), b1, p,
                                       w, "lrelu")
        compare("pack_conv3x3/chain_lrelu/bf16", y, pc.pack_conv3x3_reference(
            y1, w2.to(bf).float(), b2, p, w), TOL_KERNEL)
        pads_zero("pack_conv3x3/chain_lrelu/bf16", y, 64)
        del xpb, y, y1
    # the backward: autograd of the plain form, through the kernel's op
    wt, bias = weights(32, 64)
    xp = pc.pack_input(rand(gen, 4, 64, w, 32), p)
    gout = rand(gen, 4, 64, xp.shape[2], p * 64)
    leaves = [t.clone().requires_grad_(True) for t in (xp, wt, bias)]
    y = pc.pack_conv3x3(*leaves, p, w, "lrelu")
    grads = torch.autograd.grad(y, leaves, gout)
    ref_leaves = [t.clone().requires_grad_(True) for t in (xp, wt, bias)]
    yr = pc.pack_conv3x3_reference(*ref_leaves, p, w, "lrelu")
    ref_grads = torch.autograd.grad(yr, ref_leaves, gout)
    compare("pack_conv3x3/backward/value", y.detach(), yr.detach(), TOL_F32)
    for name, gk, gr in zip(("dx", "dw", "db"), grads, ref_grads):
        compare(f"pack_conv3x3/backward/{name}", gk, gr, TOL_F32)
    del xp, gout, leaves, y, grads, ref_leaves, yr, ref_grads
    torch.cuda.empty_cache()
    main = geometries["c64_n192"]
    return {"name": "pack_conv3x3", "route": "cuda", "source": PACK_SRC,
            "sources": [PACK_SRC, ENGINE_SRC],
            "replaces": "superresolution_tpu/ops/pallas_pairconv.py:194",
            **{k: main[k] for k in ("shape", "max_abs_err", "max_rel_err",
                                    "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "direct_ms")},
            "ptxas": PTXAS.get("PackConv"),
            "tol": TOL_KERNEL, "launches": 1,
            "path": "its entry point; no path of the system calls it",
            "geometries": geometries}


# The kernel 19 replaced (extra_kernels.cu copy_kernel, one block a band
# of rb rows) at dma_probe's shapes, as PERF.md's kernel table keeps it
# (row 19). Printed as a reference, not re-run.
COPY_OLD = "extra_kernels.cu copy_kernel, one block a band"
COPY_OLD_MS = {"lane64": 0.2323, "lane128": 0.2329}


def check_passthrough_kernel() -> dict:
    """Phase 38: kernel 19 (make_pt's passthrough) at the reference's two
    shapes, rb 94, bf16 and f32: the copy exactly equal to its input. A
    fault planted in the kernel (the last band not copied) must be
    caught, on fresh values so that stale memory cannot pass for a copy,
    band 95 alone wrong. Timed beside the plain x.clone(), dst.copy_(src)
    and the replaced kernel's time, each on the card alone (its calls
    queued behind a spin), and each unqueued as well, with the host's
    time to issue a call and the card's clocks; then dma_probe, the
    card's measured copy rate. Returns the kernels-line entry
    ([24,376,272,64])."""
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.utils import dma_probe as dp

    bf = torch.bfloat16
    cg = torch.Generator(device="cuda").manual_seed(SEED + 8)
    geometries = {}
    for tag, shape in dp.PROBE_SHAPES:
        fn = dp.make_pt(shape, dp.PROBE_RB)
        for dtype in (bf, torch.float32):
            x = torch.randn(shape, generator=cg, device="cuda").to(dtype)
            y = (entry_path("passthrough", lambda: fn(x), 1)
                 if (tag, dtype) == ("lane64", bf) else fn(x))
            if not torch.equal(y, x):
                raise AssertionError(f"passthrough/{tag}/{dtype}: the copy "
                                     "differs from its input")
            emit({"check": f"passthrough/{tag}/{dtype}", "exact": True})
            del y
            if dtype != bf:
                del x
                continue
            if tag == "lane64":
                fresh = torch.randn(shape, generator=cg, device="cuda").to(bf)

                def check():
                    bad = planted("stream_copy", _build.PLANT_LAST_BAND,
                                  lambda: fn(fresh))
                    bands = [torch.equal(u, v) for u, v in zip(
                        bad.reshape(-1, dp.PROBE_RB, *shape[2:]),
                        fresh.reshape(-1, dp.PROBE_RB, *shape[2:]))]
                    wrong = [i for i, ok in enumerate(bands) if not ok]
                    emit({"planted_fault": "last_band_not_copied",
                          "bands_wrong": wrong})
                    if wrong not in ([], [len(bands) - 1]):
                        # the fault leaves the last band alone unwritten
                        raise RuntimeError(f"passthrough: bands {wrong} "
                                           "differ, not the last alone")
                    if wrong:
                        raise AssertionError("passthrough: a band differs")

                expect_caught("passthrough:last_band_not_copied", check)
                del fresh
            dst = torch.empty_like(x)
            nbytes = x.numel() * x.element_size()
            b_ms, b_by = bound(0, 2 * nbytes)
            # device time, the calls queued behind a spin (dma_probe.
            # copy_ms); the unqueued span and the host's time to issue a
            # call beside it, on the line alone
            ms = dp.copy_ms(fn, x, 20)
            lib_ms = dp.copy_ms(dst.copy_, x, 20)
            geometries[tag] = {
                "shape": list(shape), "rb": dp.PROBE_RB, "max_abs_err": 0.0,
                "ms": ms, "gbps": 2 * nbytes / 1e9 / (ms / 1e3),
                "plain_ms": dp.copy_ms(dp.passthrough_reference, x, 20),
                "library_ms": lib_ms, "over_library": ms / lib_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "plan": {"blocks": dp.copy_grid(nbytes),
                         "chunk_bytes": dp.COPY_CHUNK}}
            emit({"phase": "kernel_time", "name": "passthrough",
                  "geometry": tag, **geometries[tag],
                  "unqueued_ms": time_ms(lambda: fn(x), 20),
                  "unqueued_library_ms": time_ms(lambda: dst.copy_(x), 20),
                  "issue_ms": issue_ms(lambda: fn(x), 20),
                  "library_issue_ms": issue_ms(lambda: dst.copy_(x), 20),
                  "card": card_state()})
            old_kernel("passthrough", COPY_OLD, list(shape), COPY_OLD_MS[tag],
                       "19", geometry=tag)
            del x, dst
    probe = dp.dma_probe()
    emit({"phase": "dma_probe", **probe,
          "nominal_gbps": PEAK_BYTES / 1e9})
    main = geometries["lane64"]
    return {"name": "passthrough", "route": "cuda", "source": STREAM_SRC,
            "sources": [STREAM_SRC, ENGINE_SRC], "replaces": "bench.py:351",
            "ptxas": ATTN_COPY_PTXAS.get("copy_kernel"),
            **{k: main[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            "tol": 0.0, "launches": 1,
            "path": "its entry point (make_pt); bench.py's probe only",
            "geometries": geometries, "dma_probe": probe}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from superresolution_tpu_torch.infer.fused_trunk import make_fused_trunk
    from superresolution_tpu_torch.infer.phase_tail import make_phase_tail
    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer_staged)
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet
    from superresolution_tpu_torch.ops import _build
    from superresolution_tpu_torch.ops.dense_trunk import fused_dense_block
    from superresolution_tpu_torch.ops.phase_tail import (
        conv_last_phase, up2_hr)
    from superresolution_tpu_torch.ops.subpixel import conv3x3_depth_to_space
    from superresolution_tpu_torch.runtime import exact_fp32_reference

    t_start = time.perf_counter()
    exact_fp32_reference()
    card = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card})

    _, build_s, ptxas = _build.build()
    _build.library()
    print("\n".join(line for line in ptxas.splitlines()
                    if "registers" in line or "spill" in line),
          file=sys.stderr)
    PTXAS.update(ptxas_usage(ptxas))
    STENCIL_PTXAS.update(stencil_ptxas(ptxas))
    ATTN_COPY_PTXAS.update(attn_copy_ptxas(ptxas))
    CHAIN_GRAD_PTXAS.update(chain_grad_ptxas(ptxas))
    CAB_PTXAS.update(cab_ptxas(ptxas))
    emit({"phase": "build", "seconds": build_s,
          "nvcc_seconds": next((line[len("nvcc seconds: "):]
                                for line in ptxas.splitlines()
                                if line.startswith("nvcc seconds: ")),
                               "not reported (cached build)"),
          "chain_grad_ptxas": CHAIN_GRAD_PTXAS
          or "not reported (cached build)",
          "conv_engine_ptxas": PTXAS or "not reported (cached build)",
          "stencil_ptxas": STENCIL_PTXAS or "not reported (cached build)",
          "attn_copy_ptxas": ATTN_COPY_PTXAS
          or "not reported (cached build)",
          "cab_ptxas": CAB_PTXAS or "not reported (cached build)"})

    gen = torch.Generator().manual_seed(SEED)
    model = RRDBNet(scale=4, in_channels=3, out_channels=3, features=64,
                    num_blocks=23, growth=32, upsampler="pixelshuffle",
                    generator=gen).to(torch.bfloat16).eval()
    with torch.no_grad():  # nonzero biases, so every check covers them
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    params = model.state_dict()
    ny, nx = -(-H // TILE[0]), -(-W // TILE[1])
    kernels = check_kernels(model, gen, ny * nx)
    torch.cuda.empty_cache()
    kernels.update(check_trunk_kernels(gen, ny * nx))
    torch.cuda.empty_cache()

    # ---- 4: the main path ----
    img = torch.rand((H, W, 3), generator=gen).cuda()
    fused = make_fused_trunk(params, model)

    def trunk_fn(x):
        return fused(x.to(torch.bfloat16))

    geom = dict(scale=4, tile=TILE, halo=HALO, tail_batch=TAIL_BATCH, h=H,
                w=W, channels=3)
    runner = make_tiled_infer_staged(trunk_fn, make_phase_tail(params),
                                     **geom)
    ops = {"fused_dense_block": fused_dense_block, "up2_hr": up2_hr,
           "conv_last_phase": conv_last_phase,
           "conv3x3_depth_to_space": conv3x3_depth_to_space,
           **unrouted_ops()}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = runner(img)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: op.launches for k, op in ops.items()}
    chunks = -(-ny * nx // TAIL_BATCH)
    expected = {"fused_dense_block": 69 * 5, "up2_hr": 2 * chunks,
                "conv_last_phase": chunks, "conv3x3_depth_to_space": 0,
                **{k: 0 for k in UNROUTED}}
    check_launches("path", launches, expected)
    if tuple(out.shape) != (4 * H, 4 * W, 3):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")
    emit({"phase": "path", "output_shape": list(out.shape),
          "dtype": str(out.dtype), "first_run_s": first_s,
          "launches_per_frame": launches, "tail_batch": TAIL_BATCH,
          "tail_chunks": chunks,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    for k in ("fused_dense_block", "up2_hr", "conv_last_phase"):
        kernels[k]["launches"] = launches[k]
    for k in ("fused_dense_block", "up2_hr"):
        kernels[k]["launches_by_body"] = BODIES["path"][k]

    run_trunk, run_tail = make_tiled_infer_staged(
        trunk_fn, make_phase_tail(params, clip=False), split_stages=True,
        **geom)
    plain_trunk, plain_tail = make_tiled_infer_staged(
        lambda x: model.trunk(x.to(torch.bfloat16)), model.tail,
        split_stages=True, **geom)
    with torch.inference_mode():
        feats = run_trunk(img)
        ref_feats = plain_trunk(img)
        compare("path/trunk_features", feats, ref_feats, TOL_PATH)
        compare("path/frame_unclipped", run_tail(feats),
                plain_tail(ref_feats), TOL_PATH)
        torch.cuda.empty_cache()

        # ---- 5: times on the card ----
        frame_s = host_clock(lambda: runner(img))
        trunk_s = host_clock(lambda: run_trunk(img))
        tail_s = host_clock(lambda: run_tail(feats))
    px_tiles = ny * nx * (TILE[0] + 2 * HALO) * (TILE[1] + 2 * HALO)
    frame_macs = px_tiles * (9 * 3 * 64 + 69 * B1_MACS + 9 * 64 * 64
                             + 9 * 64 * 256 + B2_MACS + 16 * B3_MACS)
    emit({"phase": "times", "card": card, "frame_s": frame_s,
          "mp_per_s": H * W / 1e6 / frame_s, "trunk_ms": trunk_s * 1e3,
          "tail_ms": tail_s * 1e3,
          "frame_bound_ms": 2 * frame_macs / PEAK_FLOPS * 1e3,
          "frame_tflop_per_s": 2 * frame_macs / frame_s / 1e12,
          "total_s": time.perf_counter() - t_start})
    del out, runner, run_trunk, run_tail, plain_trunk, plain_tail
    torch.cuda.empty_cache()

    # ---- 17: the frame under the levers, kernels 4-6 ----
    lever_launches = lever_frames(
        model, params, img, geom, feats, ref_feats,
        {"default_frame_s": frame_s, "default_trunk_ms": trunk_s * 1e3},
        card)
    for k in TRUNK_OPS:
        kernels[k]["launches"] = lever_launches[
            "chain_rrdb" if k == "fused_rrdb" else "fold_ends"][k]
    kernels["fused_rrdb"]["launches_by_body"] = BODIES["chain_rrdb"][
        "fused_rrdb"]
    for k in END_FOLD_BODIES:
        kernels[k]["launches_by_body"] = BODIES["fold_ends"][k]
    del img, feats, ref_feats, fused, model, params
    torch.cuda.empty_cache()

    # ---- 6-8: the hybrid RRDBNet -> HAT path ----
    gen = torch.Generator().manual_seed(SEED + 1)
    kernels.update(check_hybrid_kernels(gen))
    kernels["fused_cab_convs"]["geometries"] = {
        f"6b/{k}": v for k, v in check_cab_widths().items()}
    torch.cuda.empty_cache()
    hybrid_launches = hybrid_path(gen, card)
    for k in ("fused_cab_convs", "fused_hab_block", "flash_oca_gathered"):
        kernels[k]["launches"] = hybrid_launches[k]
    torch.cuda.empty_cache()

    # ---- 9-11: hybrid_astro training ----
    gen = torch.Generator().manual_seed(SEED + 2)
    kernels.update(check_train_kernels(gen))
    torch.cuda.empty_cache()
    f32_routes = check_f32_routes(gen)
    for k in ("fused_dense_block", "dense_block_backward"):
        kernels[k]["f32_route"] = f32_routes
    torch.cuda.empty_cache()
    train_launches = train_path(card)
    for k in ("dense_block_backward", "star_weighted_l1_cuda"):
        kernels[k]["launches"] = train_launches[k]
    kernels["dense_block_backward"]["launches_by_body"] = BODIES["train"][
        "dense_block_backward"]
    torch.cuda.empty_cache()

    # ---- 12-15: api.upscale over the flash hybrid; the quality anchor ----
    gen = torch.Generator().manual_seed(SEED + 3)
    cg = torch.Generator(device="cuda").manual_seed(SEED + 3)
    kernels.update(check_attn_kernel(cg))
    torch.cuda.empty_cache()
    upscale_launches = upscale_path(gen, card)
    kernels["flash_window_attention"]["launches"] = upscale_launches[
        "flash_window_attention"]
    torch.cuda.empty_cache()
    no_gather_path(gen)
    torch.cuda.empty_cache()
    quality_anchor()
    torch.cuda.empty_cache()

    # ---- 18-21: kernels 8-10 at the reference's other geometries, the
    # ---- hybrid_astro_h200 class, the prebound models in the tilers ----
    gen = torch.Generator().manual_seed(SEED + 4)
    cg = torch.Generator(device="cuda").manual_seed(SEED + 4)
    kernels["flash_window_attention"]["geometries"] = check_attn_geometries(
        cg)
    geo = check_hab_oca_geometries(gen)
    for k, prefix in (("fused_hab_block", "hab_"),
                      ("flash_oca_gathered", "oca_")):
        kernels[k]["geometries"] = {g: t for g, t in geo.items()
                                    if g.startswith(prefix)}
    torch.cuda.empty_cache()
    h200 = h200_path(gen, card)
    torch.cuda.empty_cache()
    ows10_path(gen)
    prebound_upscale(gen)
    emit({"phase": "h200_launches", **h200})
    torch.cuda.empty_cache()

    # ---- 22-26: the fused HAT's deploy levers, kernels 11 and 12 ----
    gen = torch.Generator().manual_seed(SEED + 5)
    kernels["strip_hab_block"] = check_strip_kernel(gen)
    kernels["fused_cab_convs_pair"] = check_cab_pair_kernel(gen)
    padded = check_padded_kernels(gen)
    for k, tag in (("fused_cab_convs", "cab_c128_creal96"),
                   ("fused_hab_block", "hab_c128_nh8_n64"),
                   ("flash_oca_gathered", "oca_c128_nh8_ws8_ows12")):
        kernels[k].setdefault("geometries", {})[tag] = padded[tag]
    torch.cuda.empty_cache()
    kernels["strip_hab_block"]["launches"] = hat_lever_paths(gen, card)
    torch.cuda.empty_cache()

    # ---- 27-30: EDSR and ESPCN serving through kernel 15 ----
    gen = torch.Generator().manual_seed(SEED + 6)
    kernels["conv3x3_depth_to_space"] = check_subpixel_kernel(gen)
    edsr_mc, edsr, edsr_launches = sr_upscale_path("edsr", gen, card, 3, 2)
    torch.cuda.empty_cache()
    _, _, espcn_launches = sr_upscale_path("espcn", gen, card, 1, 1)
    kernels["conv3x3_depth_to_space"].update(
        launches=edsr_launches + espcn_launches,
        tc_launches=edsr_launches + espcn_launches,
        launches_by_frame={"edsr": edsr_launches, "espcn": espcn_launches})
    torch.cuda.empty_cache()
    eval_folder_path(edsr_mc, edsr, gen)
    torch.cuda.empty_cache()

    # ---- 31-34: training at the reference's defaults, seg kernels ----
    gen = torch.Generator().manual_seed(SEED + 7)
    kernels.update(check_seg_kernels(gen))
    torch.cuda.empty_cache()
    packed = packed_train_path(card)
    for k in ("fused_dense_block_seg", "dense_block_backward_seg"):
        kernels[k]["launches"] = packed.get(k, 0)
    torch.cuda.empty_cache()
    kernels["conv3x3_depth_to_space"]["launches_training"] = (
        bicubic_presets_path(gen, card))
    torch.cuda.empty_cache()
    manifest_path(gen, card)
    torch.cuda.empty_cache()

    # ---- 35-38: kernels 16-19, each through its own entry point ----
    gen = torch.Generator().manual_seed(SEED + 8)
    kernels["fused_dense_block_valid"] = check_dense_valid_kernel(gen)
    torch.cuda.empty_cache()
    kernels["anti_checkerboard_kernel"] = check_blur_kernel(gen)
    torch.cuda.empty_cache()
    kernels["pack_conv3x3"] = check_pack_conv_kernel(gen)
    torch.cuda.empty_cache()
    kernels["passthrough"] = check_passthrough_kernel()
    for k in UNROUTED:
        kernels[k]["launches_system_paths"] = UNROUTED_SEEN[k]
        kernels[k]["system_paths_counted"] = len(UNROUTED_PATHS)
    kernels["fused_cab_convs_pair"]["launches"] = UNROUTED_SEEN[
        "fused_cab_convs_pair"]
    emit({"phase": "unrouted", "paths": UNROUTED_PATHS,
          "launches": UNROUTED_SEEN})
    for k in BODY_OPS:
        kernels[k]["bodies_by_path"] = {
            t: [v[k]["tc_launches"], v[k]["direct_launches"]]
            for t, v in BODIES.items() if v[k]["launches"]}
    emit({"phase": "tc_bodies", "paths_counted": len(BODIES),
          **{k: {body: sum(v[k][f"{body}_launches"] for v in BODIES.values())
                 for body in ("tc", "direct")} for k in BODY_OPS}})
    emit({"phase": "total", "total_s": time.perf_counter() - t_start})

    emit({"kernels": list(kernels.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
