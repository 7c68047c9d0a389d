#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository.  Phases, each raising on failure:

1. Require CUDA; print the card (``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader``) and the CUDA version.
2. Build the hand-written kernels from ``mimo_unet_torch/csrc`` (one nvcc
   per source, in parallel) and print the build time, ptxas's registers,
   shared memory and spills of the tensor-core kernels (the train convs
   K5-K7 and the fused DoubleConv K1/K2) and of ``train_elem.cu``'s,
   ``upsample2x.cu``'s and ``upsample_w2x.cu``'s kernels (K4, K4b, K8,
   K9, K11-K14), and the HMMA (tensor-core mma)
   instructions of each in the library's SASS (cuobjdump); raise if K5
   (fwd), K6 (dx), K7 (dw) or K1/K2 (``fused_double_conv_tc``) has none.
3. Eval kernels: call each at its flagship serving call sites (S=2, fbc=21,
   256x256, B=32, bf16) and hold it against its plain PyTorch version
   (float32, TF32 off): pool_w and upsample_w2x (K4) bitwise, K4 also
   bitwise launch to launch beside its time before its redesign
   (``OLD_ELEM_MS``), the DoubleConv
   kernels (tensor cores) at max abs <= 1e-2 * max|ref| and mean abs <=
   1e-3 * max|ref| and bitwise from one launch to the next, their times
   printed beside those of the f32 CUDA-core kernel they replaced
   (``CUDA_CORE_MS``) and of the same DoubleConv as a sequence of bf16
   cuDNN calls (``cudnn_seq_ms``: reflect pad, conv, affine + ReLU, twice,
   and the 1x1 where fused; a yardstick, no one call computes the fused
   function).  Then K1/K2 at partial tiles with fbc 40's widths (24x40
   images, B=3) and at BASELINE 5a's and 5b's up3 widths (B=2), the same
   checks, times printed but not summed; and up3's ``x2_half_h`` bitwise
   against its full-res form fed the lerped x2.
4. Serve: the flagship MimoUnetTask's model (seeded weights, random
   BatchNorm statistics) in an Ensemble answers three predict calls of 32
   random 256x256x3 images and one of a single image through the kernel
   path; the eval kernels' launch counters must show each ran, the
   outputs must be finite with variances >= 0, and they must match the
   plain model (ct_kernels="off") within 3e-2 * max|ref|.  Then one
   ``predict`` each of BASELINE 5a (S=3, fbc 30) and 5b (S=4, fbc 30), B=2
   at 256x256, on the kernel route (counters show K1 and K2) against the
   plain model at the same tolerance; and a ``torch.profiler`` table of
   one flagship B=32 forward: K2, K1 by site, the core and the rest.
5. Train kernels: every train kernel at its 640x480 call sites (NYUv2
   frames, S=2, fbc=21, B=4; down1's at 320x240), and K8, K9 and K12 also
   at the flagship 256x256 B=64 sites (N = 128; down1's at 128x128), each
   output and gradient against its plain version at the same tolerance
   as phase 3; K5, K6 and K7 (tensor cores) also bitwise from one launch
   to the next, their times printed beside those of the f32 CUDA-core
   kernels they replaced (``CUDA_CORE_MS``, from PERF.md: those are not
   built any more) and of their library calls; K9 and K8's forward
   bitwise against their plain versions, K8's backward's dy bitwise (its
   sums at the tolerance), K8, K9 and K12 (both ways) bitwise launch to
   launch, their times beside their times before their redesign
   (``OLD_ELEM_MS``) and the same function as eager bf16 calls
   (``bf16_seq_ms``, a yardstick), K12's backward split into its kernel and
   its ``reduce_groups`` pass.  Every time in phases 3, 5, 7, 10 and 13 is
   device time (``device_ms``: the calls queued behind a device-side wait,
   or, for a callable that makes the host wait, the profiler's sum of its
   device operations, named on its line); each kernel's is also printed as
   CUDA events around back-to-back calls (``events_ms``), which read the
   host where a launch outlasts its kernel.
6. Train: the NYUv2-depth task (S=2, fbc=21, bf16, Laplace NLL, lr 1e-3,
   loss buffer 10) at 640x480: ``init_state`` on the card, one step's loss
   and gradients against the plain model (ct_kernels="off", same weights:
   loss within 2e-2 relative, gradient cosine >= 0.99 per leaf above the
   noise threshold of tests/test_ct_train.py:228), then 3 ``train_step``s
   of B=16 seeded random uint8 frames whose launch counters must show
   every train kernel (K10 and K13 included) ran, K9 six times and K12's
   backward once a step, and whose loss and parameters stay finite; then
   ``val_step`` on the card model the steps left in train mode, with a CPU
   batch (a finite loss, no BatchNorm buffer moved, still in train mode);
   a profile of one B=16 step (device time by phase and the top device
   operations) and step times at B=16 and B=64.
7. Dropout kernels: the grouped 1x1 (K11) forward at the MC-serving
   decoder site (N=64 images of 256x256: 8 images x 4 MC passes x S=2)
   and forward and backward at the 640x480 B=4 train site; affine_relu
   (K8) and conv1x1_prelu (K12), forward and backward, with per-image
   parameters (groups = N) at their 640x480 B=4 and 256x256 B=64 sites;
   each against its plain version at phase 3's tolerance (K8 and K12's
   backward as in phase 5), K8, K12 and K11 also bitwise launch to launch
   beside their times before their redesign, K11's backward split into
   its kernel and its ``reduce_groups`` pass; library calls
   ``torch.baddbmm`` and, for K11's backward, its autograd backward.
8. MC serving: the flagship with the MC-dropout recipe (encoder, core and
   decoder Dropout2d at 0.1) in an ``Ensemble(monte_carlo_steps=4)``
   answers 8-image and 1-image ``predict`` requests (median latency); the
   launch counters must show K1-K4 and K11; the raw predictions must match
   the plain model (ct_kernels="off") drawing the same masks within
   3e-2 * max|ref|, and another generator must move them.
9. MC-recipe train at 640x480: one step's gradients against the plain
   model with the same masks (cosine >= 0.999 per leaf above the noise
   threshold, where the plain bf16 gradient is itself that close to the
   plain f32 model's; elsewhere no further from the f32 gradient than the
   plain bf16 model), 3 ``train_step``s of B=16 whose counters show the train
   kernels with K8 and K12 launched at groups = N (K9 six times and K12's
   backward once a step), step times at B=16
   (kernels vs plain); then one B=4 ``train_step`` of the final-dropout
   route whose counters show K11's forward and backward, and its
   gradient check against the plain model.
10. Pool and upsample kernels: K10 (forward; backward with the skip
   cotangent, and once without) and K13 (forward, backward) at their
   256x256 B=64 (N = 128) and 640x480 B=4 train sites, against their
   plain versions, bitwise; K13 also bitwise launch to launch, its times
   beside those before its redesign (``OLD_ELEM_MS``); library calls
   ``F.max_pool2d`` and ``F.interpolate`` (bilinear, align_corners) on the
   channels-last tensor, and their backward.
11. Flagship train at 256x256 patches: the NYUv2-depth task of phase 6 on
   the train kernel route (``init_state`` on the card; one B=16 step's
   loss and gradients against the plain and f32 models as in phase 9),
   3 ``train_step``s at B=64 whose counters must show every train kernel
   and exactly 2 K10 forward, 2 K10 backward, 1 K13 forward, 1 K13
   backward, 6 K9 and 1 K12 backward launch per step, a profile of one
   B=64 step, and step times at B=16 and B=64 (kernels vs plain).
12. Partial tiles: the train kernels where their blocks do not divide the
   pixels (down1 of a 48x48 step at B=3: 4.5 conv tiles per 24x24 image,
   6.75 reducing blocks per group, 2.25 per image), at fbc 40's channel
   counts, and K5/K6/K7 at H = W = 3, 4, 5 and 24 with fbc 40's in_conv
   and decoder widths (x2_half_h at even H), K8 at fbc 40's in_conv and
   down1 outputs and K13 at its 48x48 decoder input and at a 64-wide row
   of 80 channels, each against its plain version at phase 3's tolerance
   (K8 and K13 as in phases 5 and 10), K5/K6/K7, K8, K12, K11 and K13
   also bitwise launch to launch;
   then one B=3 48x48 step of the fbc-40 task on the kernel route (every
   train kernel and K10/K13 launched) with its loss and gradients against
   the plain and f32 models as in phase 9.
13. The x2-half train decoder (``MIMO_CT_TRAIN_X2_HALF=1``): K4b
   (``upsample_w2x_bwd``) and K14 (``lerp_h2x_transpose``) at the up4
   sites of the 256x256 B=64 and 640x480 B=4 steps, bitwise against
   their plain versions (K4b also launch to launch, beside its time before
   its redesign), beside their bounds and the autograd backward
   of ``F.interpolate`` (bilinear, align_corners) on the channels-last
   tensor; K5 and K7 with ``x2_half_h`` at dec.c1 (640x480 B=4) against
   their plain versions (phase 3's tolerance) and bitwise against their
   full-res form fed K13's output; K4 at the 256x256 B=64 x2-half site
   (bitwise, and launch to launch, beside its time before its redesign and
   ``F.interpolate`` of the W axis); 3 steps at 256x256 B=64 and 3 at
   640x480 B=16 whose counters must show 1 K4, 1 K4b, 1 K14, 0 K13 each
   way and 2 K10 each way per step, and every train kernel; one B=16
   256x256 step against the flag-off step on the same weights and inputs
   (logits, loss, running statistics and the decoder's gradients
   bitwise, every other gradient bitwise or no further from the flag-off
   one than a second flag-off run is); a profile of one B=64 step; step
   times and peak memory, flag on and off in turns, at 256x256 B=64 and
   640x480 B=16.
14. The train harness and the remat rungs, on the NYUv2-depth task of
   phase 6 and synthetic frames in NYUv2's uint8 schema: ``Trainer.fit``
   for 2 epochs of 256 train and 64 val frames at 256x256 B=64, whose
   launch counters must show exactly every train kernel's launches a step
   in every step and the eval kernels' a forward in validation, with
   finite losses and ``last/`` and ``best/`` written; under deterministic
   algorithms, 1 epoch and then a resume to 3 bitwise 3 straight epochs
   (parameters, buffers, Adam's moments, the schedule, the loss buffer,
   step, both generators); images/s of ``fit`` against a bare
   ``train_step`` loop over the same host-fed batches, in turns; one
   forward + backward per remat rung from the same state, at 256x256 B=64
   and on a 640x480 B=4 final-dropout step, under deterministic
   algorithms: loss, gradients and running statistics bitwise "none"'s,
   ``num_batches_tracked`` 1, and the launches beyond "none"'s exactly
   what the rung recomputes (``REMAT_AGAIN``); step time and peak memory
   per rung in turns at 256x256 and 640x480, B=64; and the capacity
   ladder (``make_train_step``) under a memory cap between "none"'s and
   "enc"'s peaks: it must choose "enc", bitwise a direct "enc" step.
15. The evidential (NIG) task, S=1, fbc 32, 4 outputs, bf16: every
   kernel of its path at its call sites (K1/K2, K3 and K4 in a 256x256
   B=32 forward; K5-K10, K12 and K13 in a 640x480 B=4 step) against its
   plain version as in phases 3, 5 and 10, its time beside the
   flagship's at the same site; one B=16 256x256 step's loss and
   gradients against the plain and f32 models as in phase 9; 3
   ``train_step``s at 256x256 B=64 whose counters must show exactly
   phase 14's launches a step; ``val_step`` with a CPU batch as in phase
   6; a profile of one B=64 step and step times at 256x256 B=64 and
   640x480 B=16 (kernels vs plain); ``Trainer.fit`` for one epoch of
   phase 14's frames, whose ``last/`` must load as an
   ``EvidentialUnetTask`` bitwise the trained state; then, under
   deterministic algorithms, ``make_predictions_evidential`` on the
   loaded model and the flagship's ``make_predictions`` through
   ``Ensemble.from_checkpoints`` of a port checkpoint and a
   reference-format Lightning ``.ckpt`` written here, 64 frames in
   batches of 32 at eps 0 and 0.01: the eval kernels exactly once per
   batch and member (none in the FGSM gradient), the perturbed inputs in
   [0, 1] and FGSM's wherever the gradient stands clear of rounding, the
   NLL on them above the clean NLL, predictions against the plain
   model's at phase 3's tolerance (the inputs bitwise), ms per batch.
16. The data layer at the flagship's width (NYUv2's 640x480 frames, S=2,
   fbc 21, B=16), on synthetic frames in NYUv2's uint8 schema made from a
   seed: 4096 frames pinned with ``DeviceDataset`` (its gather bitwise
   numpy's indexing for four index draws; ``nbytes``,
   ``device_cache_budget_bytes()`` and the share of NYUv2's train split
   that budget would pin, as arithmetic), one batch's data costs (the
   gather on the card; the host-fed gather, native and numpy, and the
   pinned staging on the host's clock); one epoch of
   ``Trainer.fit(device_cache=True)`` on 1024 of them (every batch
   gathered on the card, phase 14's launches a step, the loss falling,
   ``last/`` loading bitwise); the same fit with a budget of half the
   split (cached and host batches, every row once); images/s of the
   cached and host-fed fits in turns, the native host gather serving
   every host batch; two MC ``predict`` calls (4 passes, B=32) bitwise
   equal with another request between them.
17. The reference CLIs (``mimo_unet_torch/cli.py``, ``scripts/``) at the
   MIMO CLI's defaults, S=3, fbc 32, B=32, bf16, and SEN12TP's VV/VH ->
   NDVI at C_in = 2.  Prints which of h5py, pandas and matplotlib import
   and names each step it leaves out for that reason.  (a) Every kernel
   of the path at the S=3 fbc 32 sites (eval at 256x256 B=32; train at
   640x480 B=4 and 256x256 B=32) against its plain version as in phases
   3, 5 and 10, its time beside the flagship's at the same site; K2, K5
   and K7 at C_in = 2 beside C_in = 3.  (b) ``train_nyuv2_depth``'s
   parser with the required flags and ``--max_epochs 1``, its task from
   ``cli.build_mimo_task`` and ``cli.run_training`` on 384 + 64
   synthetic 640x480 NYUv2-schema frames, host-fed and then with
   ``--device_cache``: every step exactly phase 14's launches, the eval
   kernels' a validation batch, the loss falling, ``last/`` bitwise;
   images/s, step time and peak memory; step times at 640x480 and
   256x256, B=32, and a profile of one 640x480 B=32 step.  (c)
   ``train_ndvi`` and ``train_ndvi_evidential`` whole, each in a process
   of its own, at their defaults (``--max_epochs 1``) on seeded
   2000x2000 ``.npz`` tiles with the real band names, their launches
   counted in that process (phase 14's a step, the eval kernels' a
   validation batch) and ``hparams.json`` in_channels 2; then
   ``test_ndvi`` and ``test_ndvi_evidential`` on those checkpoints, whole
   where pandas imports, else their prediction step here: the eval
   kernels once a batch and member, finite predictions.  (d)
   ``measure_inference_speed`` whole on the NYUv2 checkpoint at 480x640
   and the NDVI one at 256x256, 200 repetitions: both lines.
18. Print the kernels' JSON line (K10/K13 launches from phase 11, K4b and
   K14 from phase 13; the evidential sites and launches and phase 17's
   S=3 fbc 32 and C_in = 2 sites with the CLI runs' launches as entries
   of their own), then the result line ``{"ok": true, "device": {...}}``
   last.

Every time carries the card's name and power limit.  Exits non-zero,
printing no result, without CUDA or outside the repo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B, S, F, HW = 32, 2, 21, 256           # eval flagship
TB, TH, TW = 4, 480, 640               # train kernel call sites (NYUv2)
TRAIN_B, BIG_B = 16, 64                # train steps; the documented batch
NYU, PATCH = (TH, TW), (HW, HW)        # train frame sizes: NYUv2, flagship
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM bf16 dense, HBM3
_E = "mimo_unet_tpu/ops/pallas/"
KERNEL_INFO = {
    "fused_double_conv": ("mimo_unet_torch/csrc/fused_double_conv.cu", _E + "ct_conv.py:756"),
    "fused_double_conv9": ("mimo_unet_torch/csrc/fused_double_conv.cu", _E + "ct_conv.py:496"),
    "pool_w": ("mimo_unet_torch/csrc/pool_w.cu", _E + "ct_elem.py:193"),
    "upsample_w2x": ("mimo_unet_torch/csrc/upsample_w2x.cu", _E + "ct_resize.py:222"),
    "conv3x3_fwd": ("mimo_unet_torch/csrc/conv3x3_train.cu", _E + "ct_train.py:283"),
    "conv3x3_dx": ("mimo_unet_torch/csrc/conv3x3_train.cu", _E + "ct_train.py:579"),
    "conv3x3_dx_fold": ("mimo_unet_torch/csrc/conv3x3_train.cu", _E + "ct_train.py:677"),
    "conv3x3_dw": ("mimo_unet_torch/csrc/conv3x3_train.cu", _E + "ct_train.py:815"),
    "g_eff": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:140"),
    "affine_relu": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:83"),
    "affine_relu_bwd": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:106"),
    "conv1x1_prelu": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:527"),
    "conv1x1_prelu_bwd": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:560"),
    "conv1x1": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:437"),
    "conv1x1_bwd": ("mimo_unet_torch/csrc/train_elem.cu", _E + "ct_elem.py:464"),
    "max_pool2x2": ("mimo_unet_torch/csrc/pool2x2.cu", _E + "ct_elem.py:282"),
    "max_pool2x2_bwd": ("mimo_unet_torch/csrc/pool2x2.cu", _E + "ct_elem.py:336"),
    "upsample2x": ("mimo_unet_torch/csrc/upsample2x.cu", _E + "ct_resize.py:59"),
    "upsample2x_bwd": ("mimo_unet_torch/csrc/upsample2x.cu", _E + "ct_resize.py:124"),
    "upsample_w2x_bwd": ("mimo_unet_torch/csrc/upsample_w2x.cu", _E + "ct_resize.py:254"),
    "lerp_h2x_transpose": ("mimo_unet_torch/csrc/upsample2x.cu", _E + "ct_resize.py:295"),
}
X2_HALF = "MIMO_CT_TRAIN_X2_HALF"  # the x2-half train decoder's switch
# K1, K2, K5, K6 and K7 as f32 CUDA-core kernels, before their tensor-core
# redesign (PERF.md section 6), ms at the phase-3 and phase-5 sites by site
# label prefix; those kernels are not built any more
CUDA_CORE_MS = {
    ("fused_double_conv9", "in_conv"): 3.650, ("fused_double_conv", "down1"): 3.532,
    ("fused_double_conv", "up3"): 10.977, ("fused_double_conv", "decoder"): 14.948,
    ("conv3x3_fwd", "in_conv.conv1"): 0.589, ("conv3x3_fwd", "in_conv.conv2"): 2.611,
    ("conv3x3_fwd", "down1.conv1"): 1.174, ("conv3x3_fwd", "down1.conv2"): 2.498,
    ("conv3x3_fwd", "decoder conv1"): 9.063, ("conv3x3_fwd", "decoder conv2"): 3.796,
    ("conv3x3_dw", "in_conv.conv1"): 3.765, ("conv3x3_dw", "in_conv.conv2"): 5.670,
    ("conv3x3_dw", "down1.conv1"): 4.527, ("conv3x3_dw", "down1.conv2"): 5.279,
    ("conv3x3_dw", "decoder conv1"): 16.432, ("conv3x3_dw", "decoder conv2"): 7.703,
    ("conv3x3_dx", "in_conv.conv2"): 3.050, ("conv3x3_dx", "down1.conv1"): 1.437,
    ("conv3x3_dx", "down1.conv2"): 2.888, ("conv3x3_dx", "decoder conv2"): 3.076,
    ("conv3x3_dx_fold", "decoder conv1"): 8.488,
}
# K9, K12, K8, K13, K4 and K11 before their redesign for the memory
# system (K9, K8, K4: one bf16 element a thread with 64-bit index
# divisions; K12's, K8's and K11's backward: 256-pixel blocks of 32 x 8
# lanes; K12's and K11's forward: a thread a pixel reading 2-byte scalars,
# blocks of 256 pixels; K13 and K4b: a block an output row, a thread a
# channel pair), ms at the phase-3, 5, 7, 10 and 13 sites by site label:
# PERF.md section 6 (K9's 256x256 B=64 sites from tools/train_elem_ab.py),
# CUDA events around back-to-back calls
OLD_ELEM_MS = {
    ("g_eff", "in_conv.conv1 3->21: y 21 ch"): 0.200,
    ("g_eff", "in_conv.conv2 21->21 +prologue: y 21 ch"): 0.199,
    ("g_eff", "down1.conv1 21->42 @320x240: y 42 ch"): 0.102,
    ("g_eff", "down1.conv2 42->42 +prologue @320x240: y 42 ch"): 0.102,
    ("g_eff", "decoder conv1 (21+42)->31 x2 period 4: y 31 ch"): 0.292,
    ("g_eff", "decoder conv2 31->21 +prologue: y 21 ch"): 0.201,
    ("g_eff", "in_conv.conv1 3->21 @256x256 B=64: y 21 ch"): 0.6693,
    ("g_eff", "in_conv.conv2 21->21 @256x256 B=64: y 21 ch"): 0.6722,
    ("g_eff", "down1.conv1 21->42 @128x128 B=64: y 42 ch"): 0.3357,
    ("g_eff", "down1.conv2 42->42 @128x128 B=64: y 42 ch"): 0.3363,
    ("g_eff", "decoder conv1 (21+42)->31 @256x256 B=64: y 31 ch"): 0.9888,
    ("g_eff", "decoder conv2 31->21 @256x256 B=64: y 21 ch"): 0.6720,
    ("conv1x1_prelu_bwd", "decoder bn2 + ReLU + out-conv 21->2"): 0.501,
    ("conv1x1_prelu_bwd", "decoder bn2 + ReLU + out-conv 21->2 @256 B=64"): 1.6355,
    ("conv1x1_prelu_bwd", "decoder up4 Dropout2d + out-conv, groups=8"): 0.486,
    ("conv1x1_prelu_bwd", "decoder up4 Dropout2d + out-conv, groups=128 @256"): 1.5838,
    ("affine_relu", "in_conv output x1s 21 ch"): 0.1848,
    ("affine_relu", "down1 output 42 ch @320x240"): 0.0985,
    ("affine_relu", "in_conv output x1s 21 ch @256x256 B=64"): 0.6144,
    ("affine_relu", "down1 output 42 ch @128x128 B=64"): 0.3109,
    ("affine_relu", "in_conv x1s 21 ch, groups=8"): 0.1768,
    ("affine_relu", "in_conv x1s 21 ch, groups=128 @256"): 0.5992,
    ("affine_relu_bwd", "in_conv output x1s 21 ch"): 0.2984,
    ("affine_relu_bwd", "down1 output 42 ch @320x240"): 0.2013,
    ("affine_relu_bwd", "in_conv output x1s 21 ch @256x256 B=64"): 0.9566,
    ("affine_relu_bwd", "down1 output 42 ch @128x128 B=64"): 0.6116,
    ("affine_relu_bwd", "in_conv x1s 21 ch, groups=8"): 0.2710,
    ("affine_relu_bwd", "in_conv x1s 21 ch, groups=128 @256"): 0.8454,
    ("upsample2x", "decoder input 256x256 B=64 [64,128,128,42]"): 0.3469,
    ("upsample2x", "decoder input 480x640 B=4 [4,240,320,42]"): 0.1107,
    ("upsample2x_bwd", "decoder input 256x256 B=64"): 0.5379,
    ("upsample2x_bwd", "decoder input 480x640 B=4"): 0.1705,
    ("upsample_w2x", "up3 W-half [32,64,64,84]"): 0.1015,
    ("upsample_w2x", "decoder W-half [32,128,128,42]"): 0.2001,
    ("upsample_w2x", "x2-half up4 W-half 256x256 B=64 [64, 128, 128, 42]"): 0.3933,
    ("conv1x1_prelu", "decoder bn2 + ReLU + out-conv 21->2"): 0.1087,
    ("conv1x1_prelu", "decoder bn2 + ReLU + out-conv 21->2 @256 B=64"): 0.3036,
    ("conv1x1_prelu", "decoder up4 Dropout2d + out-conv, groups=8"): 0.1018,
    ("conv1x1_prelu", "decoder up4 Dropout2d + out-conv, groups=128 @256"): 0.3016,
    ("conv1x1", "MC decoder 21->2, N=64 @256"): 0.140,
    ("conv1x1", "final-dropout decoder 21->2, N=8 @640x480"): 0.084,
    ("conv1x1_bwd", "final-dropout decoder 21->2, N=8 @640x480"): 0.551,
    ("upsample_w2x_bwd", "up4 W-half cotangent 256x256 B=64 [64,128,256,42]"): 0.1543,
    ("upsample_w2x_bwd", "up4 W-half cotangent 480x640 B=4 [4,240,640,42]"): 0.0606,
}
# redesigned for the memory system: launch to launch bitwise
REDESIGNED = ("g_eff", "conv1x1_prelu_bwd", "affine_relu", "affine_relu_bwd", "upsample2x",
              "upsample2x_bwd", "upsample_w2x", "conv1x1_prelu", "conv1x1", "conv1x1_bwd",
              "upsample_w2x_bwd")
# K8's backward: dy bitwise against the plain version, its sums (another
# order) at phase 3's tolerance
K8_BWD_EXACT = (True, False, False)
TC_KERNELS = ("conv3x3_fwd", "conv3x3_dx", "conv3x3_dx_fold", "conv3x3_dw",
              "fused_double_conv", "fused_double_conv9")  # tensor cores
# the documented MC-dropout recipe (reference Readme.md:82)
MC_RECIPE = dict(encoder_dropout_rate=0.1, core_dropout_rate=0.1,
                 decoder_dropout_rate=0.1)
MC_STEPS, MC_B = 4, 8                  # MC passes; images per MC request


@dataclasses.dataclass
class Site:
    """One kernel call site: the kernel call, its plain version, whether
    they must agree bitwise, the work (operations, bytes) the call must do,
    and the nearest single PyTorch call, if any."""
    name: str
    site: str
    kern: object
    plain: object
    exact: object           # bool, or one bool per output
    flops: float
    nbytes: float
    library: object = None
    before: object = None   # the replaced kernel's time (PERF.md), where redesigned
    repeat: bool = False    # two launches must agree bitwise
    seq: object = None      # the same function as eager bf16 calls (yardstick)
    fdc: object = None      # K1/K2: the call's (x1, DoubleConv arguments, options)
    seq_label: str = "cudnn_seq_ms"
    parts: object = None    # {part: call} timed one by one (K12's and K11's backward)


@functools.lru_cache(maxsize=1)
def _cycles_per_ms():
    """The rate at which ``torch.cuda._sleep`` spins the device, measured
    once."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def _spin(ms):
    """Queue a device-side wait of ``ms`` on the current stream."""
    import torch

    torch.cuda._sleep(int(ms * _cycles_per_ms()))


def events_ms(fn, iters):
    """Mean time of ``fn()`` between CUDA events around ``iters``
    back-to-back calls after one warm-up: where the host takes longer to
    launch a call than the device to run it, the host's rate."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls after one warm-up,
    and how it was taken.

    One call is first made behind a device-side wait of 10 ms
    (``torch.cuda._sleep``): if the wait has ended when the call returns,
    the call made the host wait for the device (a copy from host memory, a
    synchronising call).  Otherwise the ``iters`` calls are queued behind a
    wait of three times the host's time to enqueue them (at least 1 ms),
    between CUDA events, and the start event must still be pending when
    the host has enqueued them all (else the wait is taken 8 times longer,
    once): then the events time the device alone, "queued".  A callable
    that synchronises or fills the launch queue is timed by
    ``torch.profiler`` instead, as the sum of its calls' device operations,
    "profiler (synchronises)": never the host's time, unless three traces
    recorded no device operation, when the CUDA events' reading is given
    and says so."""
    import torch

    fn()
    torch.cuda.synchronize()
    probe = torch.cuda.Event()
    _spin(10.0)
    probe.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    waited = probe.query()
    torch.cuda.synchronize()
    wait = max(1.0, 3 * host * iters)
    for _ in range(0 if waited else 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _spin(wait)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        late = start.query()
        torch.cuda.synchronize()
        if not late:
            return start.elapsed_time(end) / iters, "queued"
        wait *= 8
    try:
        return busy_ms(lambda: [fn() for _ in range(iters)]) / iters, "profiler (synchronises)"
    except AssertionError:  # three traces without a device operation
        return events_ms(fn, iters), "events: the profiler recorded nothing"


def busy_ms(run):
    """Device time of ``run()``: the sum of its device operations' times in
    one ``torch.profiler`` trace (the device's busy time, gaps left out).
    A trace that recorded no device operation (seen once in a run: a K6
    site read 0 ms) is taken again, at most twice; then the call raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3
    raise AssertionError("torch.profiler recorded no device operation in three traces")


def cuda_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls (``device_ms``)."""
    return device_ms(fn, iters)[0]


def compare(name, got, want, exact):
    """Max abs error of ``got`` vs ``want`` (tuples compared pairwise;
    ``exact`` a bool, or one per output); raises past the tolerance."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs vs {len(want)}")
    exacts = exact if isinstance(exact, tuple) else (exact,) * len(got)
    worst = 0.0
    for g, w, exact in zip(got, want, exacts):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {tuple(g.shape)} {g.dtype} vs "
                                 f"{tuple(w.shape)} {w.dtype}")
        err = (g.float() - w.float()).abs()
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"{name}: non-finite output")
        worst = max(worst, float(err.max()))
        if exact:
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: not bitwise equal "
                                     f"(max abs {float(err.max())})")
            continue
        scale = float(w.float().abs().max()) or 1.0
        if float(err.max()) > 1e-2 * scale or float(err.mean()) > 1e-3 * scale:
            raise AssertionError(f"{name}: max abs {float(err.max())}, mean abs "
                                 f"{float(err.mean())}, scale {scale}")
    return worst


def _mode(exact):
    """How a site's outputs are held: "bitwise", "tolerance", or K8's
    backward's mix."""
    return {True: "bitwise", False: "tolerance"}.get(exact, "dy bitwise, sums tolerance")


def _nbytes(*shapes_and_sizes):
    """Sum of prod(shape) * element size over (shape, element size) pairs."""
    total = 0
    for shape, size in shapes_and_sizes:
        n = 1
        for d in shape:
            n *= d
        total += n * size
    return float(total)


def _dc(dev, gen, g, cin, m, o):
    """Seeded grouped DoubleConv arguments (w1, s1, sh1, w2, s2, sh2)."""
    import torch

    w1 = (torch.rand((g, 3, 3, cin, m), device=dev, generator=gen) * 2 - 1) / (9 * cin) ** 0.5
    w2 = (torch.rand((g, 3, 3, m, o), device=dev, generator=gen) * 2 - 1) / (9 * m) ** 0.5
    s1 = torch.rand((g, m), device=dev, generator=gen) + 0.5
    s2 = torch.rand((g, o), device=dev, generator=gen) + 0.5
    sh1 = torch.randn((g, m), device=dev, generator=gen) * 0.1
    sh2 = torch.randn((g, o), device=dev, generator=gen) * 0.1
    return w1, s1, sh1, w2, s2, sh2


def cudnn_seq(x1, dc, x2=None, x2_half_h=False, wo=None, bo=None, **_):
    """The DoubleConv of a K1/K2 site as bf16 cuDNN calls on the
    channels-last tensor with the groups on channels: reflect pad, conv,
    affine + ReLU, reflect pad, conv, affine + ReLU, and the 1x1 where the
    kernel fuses it.  The concat input (x2 lerped and tiled) is made once,
    outside the timed call.  A yardstick only."""
    import torch
    import torch.nn.functional as Fn
    from mimo_unet_torch.kernels.fused_double_conv import lerp_h2x_plain

    bf = torch.bfloat16
    w1, s1, sh1, w2, s2, sh2 = dc
    g = w1.shape[0]
    n, h, w, _ = x1.shape
    per = n // g
    z = x1
    if x2 is not None:
        xb = lerp_h2x_plain(x2) if x2_half_h else x2
        z = torch.cat([x1, xb.repeat(n // x2.shape[0], 1, 1, 1)], -1)
    zl = (z.view(g, per, h, w, -1).permute(1, 0, 4, 2, 3).reshape(per, -1, h, w)
          .contiguous(memory_format=torch.channels_last))

    def lw(t):  # [G, 3, 3, C, O] -> [G*O, C, 3, 3]
        return t.permute(0, 4, 3, 1, 2).reshape(-1, t.shape[3], 3, 3).to(bf).contiguous(
            memory_format=torch.channels_last)

    def la(t):
        return t.reshape(1, -1, 1, 1).to(bf)

    wl1, wl2, a1, b1, a2, b2 = lw(w1), lw(w2), la(s1), la(sh1), la(s2), la(sh2)
    wol = bol = None
    if wo is not None:
        wol = wo.permute(0, 2, 1).reshape(-1, wo.shape[1], 1, 1).to(bf)
        bol = bo.reshape(-1).to(bf)

    def run():
        y = Fn.conv2d(Fn.pad(zl, (1, 1, 1, 1), mode="reflect"), wl1, groups=g)
        y = torch.relu_(torch.addcmul(b1, y, a1))
        y = Fn.conv2d(Fn.pad(y, (1, 1, 1, 1), mode="reflect"), wl2, groups=g)
        y = torch.relu_(torch.addcmul(b2, y, a2))
        return y if wol is None else Fn.conv2d(y, wol, bol, groups=g)

    return run


def fdc_site(label, x1, dc, **kw):
    """A K1 (or, for a 3-channel single input, K2) site: the kernel, its
    plain version, its work (conv FLOPs; activations, weights and outputs
    once) and its cuDNN sequence; ``kw`` the wrapper's options (x2,
    x2_half_h, wo, bo, emit_hpool, group_rows_out)."""
    from mimo_unet_torch import kernels as K

    w1, _, _, w2, _, _ = dc
    g, cin, m = w1.shape[0], w1.shape[3], w1.shape[4]
    o = w2.shape[4]
    n, h, w, _ = x1.shape
    nine = kw.get("x2") is None and cin <= 8
    kern = K.fused_double_conv9 if nine else K.fused_double_conv
    plain = K.fused_double_conv9_plain if nine else K.fused_double_conv_plain
    oc = 0 if kw.get("wo") is None else kw["wo"].shape[2]
    px = n * h * w
    flops = 2.0 * px * (9 * cin * m + 9 * m * o + o * oc)
    ins = [x1.shape] + ([kw["x2"].shape] if kw.get("x2") is not None else [])
    outs = [(n, h, w, oc or o)] + ([(n, h // 2, w, o)] if kw.get("emit_hpool") else [])
    wbytes = g * 9 * (cin * m + m * o) * 2 + g * o * oc * 2
    return Site(kern.__name__, label, lambda: kern(x1, *dc, **kw),
                lambda: plain(x1, *dc, **kw), False, flops,
                _nbytes(*[(t, 2) for t in ins + outs]) + wbytes,
                seq=cudnn_seq(x1, dc, **kw), fdc=(x1, dc, kw))


def eval_sites(dev, gen, s=S, f=F, b=B, oc=2, tag="", cin=3):
    """The eval kernels at the call-site shapes of
    mimo_unet_torch/models/fast_path.py ``mimo_unet_apply_fast``: the
    flagship's (S=2, fbc 21, B=32, 2 outputs), or ``s`` subnetworks of
    ``f`` filters, ``b`` images, ``cin`` input channels and ``oc``
    outputs, each label prefixed with ``tag``."""
    import torch
    import torch.nn.functional as Fn
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    fs = f * s

    def act(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(bf)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    n = s * b
    sites = []
    x = act(n, HW, HW, cin)
    sites.append(fdc_site(f"{tag}in_conv {cin}->{f}->{f} @256 +hpool", x,
                          _dc(dev, gen, s, cin, f, f), emit_hpool=True))
    hp1 = act(n, HW // 2, HW, f)
    sites.append(Site("pool_w", f"{tag}down1 pool [{n},{HW // 2},{HW},{f}]",
                      lambda: K.pool_w(hp1), lambda: K.pool_w_plain(hp1), True,
                      hp1.numel() / 2, _nbytes((hp1.shape, 2)) * 1.5,
                      lambda: Fn.max_pool2d(nchw(hp1), (1, 2))))
    p1 = act(n, HW // 2, HW // 2, f)
    sites.append(fdc_site(f"{tag}down1 {f}->{2 * f}->{2 * f} @128 +hpool +group_rows_out", p1,
                          _dc(dev, gen, s, f, 2 * f, 2 * f), emit_hpool=True,
                          group_rows_out=True))
    hp2 = act(b, HW // 4, HW // 2, 2 * fs)
    sites.append(Site("pool_w", f"{tag}core pool [{b},{HW // 4},{HW // 2},{2 * fs}]",
                      lambda: K.pool_w(hp2), lambda: K.pool_w_plain(hp2), True,
                      hp2.numel() / 2, _nbytes((hp2.shape, 2)) * 1.5,
                      lambda: Fn.max_pool2d(nchw(hp2), (1, 2))))
    xu2 = act(b, HW // 4, HW // 4, 2 * fs)
    sites.append(Site("upsample_w2x", f"{tag}up3 W-half [{b},{HW // 4},{HW // 4},{2 * fs}]",
                      lambda: K.upsample_w2x(xu2),
                      lambda: K.upsample_w2x_plain(xu2), True,
                      3.0 * xu2.numel() * 2, _nbytes((xu2.shape, 2)) * 3,
                      lambda: Fn.interpolate(nchw(xu2), size=(HW // 4, HW // 2),
                                             mode="bilinear", align_corners=True)))
    x2cat, xu2w = act(b, HW // 2, HW // 2, 2 * fs), act(b, HW // 4, HW // 2, 2 * fs)
    sites.append(fdc_site(f"{tag}up3 ({2 * fs}+{2 * fs})->{2 * fs}->{fs} @128 +x2_half_h",
                          x2cat, _dc(dev, gen, 1, 4 * fs, 2 * fs, fs), x2=xu2w,
                          x2_half_h=True))
    xup = act(b, HW // 2, HW // 2, fs)
    sites.append(Site("upsample_w2x", f"{tag}decoder W-half [{b},{HW // 2},{HW // 2},{fs}]",
                      lambda: K.upsample_w2x(xup),
                      lambda: K.upsample_w2x_plain(xup), True,
                      3.0 * xup.numel() * 2, _nbytes((xup.shape, 2)) * 3,
                      lambda: Fn.interpolate(nchw(xup), size=(HW // 2, HW),
                                             mode="bilinear", align_corners=True)))
    x1s, xupw = act(n, HW, HW, f), act(b, HW // 2, HW, fs)
    wo = (torch.rand((s, f, oc), device=dev, generator=gen) * 2 - 1) / f ** 0.5
    bo = torch.randn((s, oc), device=dev, generator=gen) * 0.1
    sites.append(fdc_site(f"{tag}decoder ({f}+{fs})->{(f + fs) // 2}->{f}->{oc} @256 "
                          f"+x2_half_h +out-conv", x1s,
                          _dc(dev, gen, s, f + fs, (f + fs) // 2, f), x2=xupw,
                          x2_half_h=True, wo=wo, bo=bo))
    return _tc_marked(sites)


def eval_extra_sites(dev, gen):
    """K1/K2 where their tiles do not divide the image (24x40 images, B=3,
    at fbc 40's widths: in_conv 3->40->40, down1 40->80->80 at 12x20, up3
    (160+160)->160->80 and the decoder (40+80)->60->40 (with and without
    the out-conv, as MC serving runs it)), and up3 at BASELINE 5a's (S=3,
    fbc 30: (180+180)->180->90) and 5b's (S=4: (240+240)->240->120)
    widths, B=2 at 256x256; the list of (name, x2_half_h call, its
    full-res form) for up3's bitwise check."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.kernels.fused_double_conv import lerp_h2x_plain

    bf = torch.bfloat16

    def act(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(bf)

    sites, same = [], []
    f, s, b, h, w = 40, 2, 3, 24, 40
    n, fs = s * b, f * s
    sites.append(fdc_site(f"fbc40 {w}x{h} in_conv 3->40->40 +hpool", act(n, h, w, 3),
                          _dc(dev, gen, s, 3, f, f), emit_hpool=True))
    sites.append(fdc_site(f"fbc40 {w // 2}x{h // 2} down1 40->80->80 +hpool +group_rows_out",
                          act(n, h // 2, w // 2, f), _dc(dev, gen, s, f, 2 * f, 2 * f),
                          emit_hpool=True, group_rows_out=True))
    sites.append(fdc_site(f"fbc40 {w // 2}x{h // 2} up3 (160+160)->160->80 +x2_half_h",
                          act(b, h // 2, w // 2, 2 * fs), _dc(dev, gen, 1, 4 * fs, 2 * fs, fs),
                          x2=act(b, h // 4, w // 2, 2 * fs), x2_half_h=True))
    x1s, xupw = act(n, h, w, f), act(b, h // 2, w, fs)
    dec = _dc(dev, gen, s, f + fs, (f + fs) // 2, f)
    wo = (torch.rand((s, f, 2), device=dev, generator=gen) * 2 - 1) / f ** 0.5
    bo = torch.randn((s, 2), device=dev, generator=gen) * 0.1
    sites.append(fdc_site(f"fbc40 {w}x{h} decoder (40+80)->60->40->2 +out-conv", x1s, dec,
                          x2=xupw, x2_half_h=True, wo=wo, bo=bo))
    sites.append(fdc_site(f"fbc40 {w}x{h} decoder (40+80)->60->40 (MC serving)", x1s, dec,
                          x2=xupw, x2_half_h=True))
    for tag, s5 in (("5a", 3), ("5b", 4)):
        fs5 = 30 * s5
        x2cat, xu2w = act(2, HW // 2, HW // 2, 2 * fs5), act(2, HW // 4, HW // 2, 2 * fs5)
        u = _dc(dev, gen, 1, 4 * fs5, 2 * fs5, fs5)
        sites.append(fdc_site(f"{tag} up3 ({2 * fs5}+{2 * fs5})->{2 * fs5}->{fs5} @128 B=2 "
                              f"+x2_half_h", x2cat, u, x2=xu2w, x2_half_h=True))
        full = lerp_h2x_plain(xu2w).contiguous()
        same.append((f"{tag} up3",
                     lambda x2cat=x2cat, u=u, xu2w=xu2w: K.fused_double_conv(
                         x2cat, *u, x2=xu2w, x2_half_h=True),
                     lambda x2cat=x2cat, u=u, full=full: K.fused_double_conv(
                         x2cat, *u, x2=full)))
    return _tc_marked(sites), same


def g_eff_seq(dy, y, dsum, dsumsq):
    """K9's function as eager bf16 calls (a yardstick)."""
    import torch

    bf = torch.bfloat16
    g, o = dsum.shape
    out = dy.view(g, -1, o) + dsum.to(bf)[:, None]
    return out.add_((2 * y.view(g, -1, o)) * dsumsq.to(bf)[:, None])


def prelu_bwd_seq(gl, y, scale, shift, wo):
    """K12's backward as eager bf16 calls (a yardstick)."""
    import torch

    bf = torch.bfloat16
    groups, c = scale.shape
    yv, g = y.view(groups, -1, c), gl.view(groups, -1, gl.shape[-1])
    sc = scale.to(bf)[:, None]
    a = yv * sc + shift.to(bf)[:, None]
    live = a > 0
    da = torch.bmm(g, wo.to(bf).transpose(1, 2)) * live
    return ((da * sc).view(y.shape), (da * yv).sum(1, dtype=torch.float32),
            da.sum(1, dtype=torch.float32), torch.bmm((a * live).transpose(1, 2), g),
            g.sum(1, dtype=torch.float32))


def affine_relu_seq(y, scale, shift):
    """K8's forward as eager bf16 calls (a yardstick)."""
    import torch

    bf = torch.bfloat16
    groups, c = scale.shape
    yv = y.view(groups, -1, c)
    return torch.relu(yv * scale.to(bf)[:, None] + shift.to(bf)[:, None]).view(y.shape)


def affine_relu_bwd_seq(dz, y, scale, shift):
    """K8's backward as eager bf16 calls (a yardstick)."""
    import torch

    bf = torch.bfloat16
    groups, c = scale.shape
    yv, d = y.view(groups, -1, c), dz.view(groups, -1, c)
    sc = scale.to(bf)[:, None]
    da = d * (yv * sc + shift.to(bf)[:, None] > 0)
    return ((da * sc).view(y.shape), (da * yv).sum(1, dtype=torch.float32),
            da.sum(1, dtype=torch.float32))


def prelu_seq(y, scale, shift, wo, bo):
    """K12's forward as eager bf16 calls (a yardstick): the affine and
    ReLU, then the grouped 1x1 as one batched product with its bias."""
    import torch

    bf = torch.bfloat16
    groups, c = scale.shape
    yv = y.view(groups, -1, c)
    z = torch.relu(yv * scale.to(bf)[:, None] + shift.to(bf)[:, None])
    return torch.baddbmm(bo.to(bf)[:, None, :], z, wo.to(bf))


def k8_sites(label, y, dz, scale, shift, n, hh, ww, c):
    """K8 forward and backward at one call site, with their eager bf16
    sequences: the forward bitwise, the backward's dy bitwise."""
    from mimo_unet_torch import kernels as K

    elem = _nbytes(((n, hh, ww, c), 2))
    return [Site("affine_relu", label,
                 lambda: K.affine_relu(y, scale, shift),
                 lambda: K.affine_relu_plain(y, scale, shift),
                 True, 3.0 * n * hh * ww * c, 2 * elem,
                 seq=lambda: affine_relu_seq(y, scale, shift), seq_label="bf16_seq_ms"),
            Site("affine_relu_bwd", label,
                 lambda: K.affine_relu_bwd(dz, y, scale, shift),
                 lambda: K.affine_relu_bwd_plain(dz, y, scale, shift),
                 K8_BWD_EXACT, 6.0 * n * hh * ww * c, 3 * elem,
                 seq=lambda: affine_relu_bwd_seq(dz, y, scale, shift),
                 seq_label="bf16_seq_ms")]


def prelu_bwd_parts(gl, y, scale, shift, wo):
    """K12's backward as its two launches, each callable alone: the kernel
    (dy and the partial rows) and the reduce_groups pass over them."""
    import torch
    from mimo_unet_torch.kernels import _build
    from mimo_unet_torch.kernels import train_elem as TE

    n, h, w, c = y.shape
    groups, oc = wo.shape[0], wo.shape[2]
    sc, sh = scale.float().contiguous(), shift.float().contiguous()
    wob = wo.to(torch.bfloat16).contiguous()
    dy = torch.empty_like(y)
    part = torch.empty((TE.prelu_bwd_blocks(n, h * w, c, oc, groups),
                        c * oc + oc + 2 * c), device=y.device)

    def kernel():
        _build.launch("mimo_conv1x1_prelu_bwd", y.device, gl.data_ptr(), y.data_ptr(),
                      sc.data_ptr(), sh.data_ptr(), wob.data_ptr(), dy.data_ptr(),
                      part.data_ptr(), n, h * w, c, oc, groups)
    return {"kernel": kernel, "reduce_groups": lambda: TE.reduce_groups(part, groups)}


def conv1x1_bwd_parts(g, z, wo):
    """K11's backward as its two launches, each callable alone: the kernel
    (dz and the partial rows) and the reduce_groups pass over them."""
    import torch
    from mimo_unet_torch.kernels import _build
    from mimo_unet_torch.kernels import train_elem as TE

    n, h, w, c = z.shape
    groups, oc = wo.shape[0], wo.shape[2]
    wob = wo.to(torch.bfloat16).contiguous()
    dz = torch.empty_like(z)
    part = torch.empty((TE.conv1x1_bwd_blocks(n, h * w, c, oc, groups), c * oc + oc),
                       device=z.device)

    def kernel():
        _build.launch("mimo_conv1x1_bwd", z.device, g.data_ptr(), z.data_ptr(),
                      wob.data_ptr(), dz.data_ptr(), part.data_ptr(), n, h * w, c, oc, groups)
    return {"kernel": kernel, "reduce_groups": lambda: TE.reduce_groups(part, groups)}


def _redesigned(sites):
    """K9, K12, K8, K13, K4, K11 and K4b: launch to launch bitwise, with
    their time before the redesign."""
    for st in sites:
        if st.name in REDESIGNED:
            st.repeat = True
            st.before = OLD_ELEM_MS.get((st.name, st.site))
    return sites


def elem_sites_256(dev, gen):
    """K8, K9 and K12 at their call sites of the flagship step at 256x256,
    B=64 (models/fast_path.py ``mimo_unet_apply_train``: N = S*B = 128
    images, down1's at 128x128): K9 on each of the six convs' outputs, K8
    on in_conv's and down1's outputs, K12 on the decoder's last conv
    output.  Eager bf16 sequences of K9 and K12's backward as yardsticks."""
    import torch
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    n, h2 = S * BIG_B, HW // 2
    mid = (F + F * S) // 2

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    def affine(c):
        return (torch.rand((S, c), device=dev, generator=gen) + 0.5,
                torch.randn((S, c), device=dev, generator=gen) * 0.1)

    sites = []
    for label, hh, o in (("in_conv.conv1 3->21", HW, F), ("in_conv.conv2 21->21", HW, F),
                         ("down1.conv1 21->42", h2, 2 * F), ("down1.conv2 42->42", h2, 2 * F),
                         ("decoder conv1 (21+42)->31", HW, mid),
                         ("decoder conv2 31->21", HW, F)):
        g, y = act(n, hh, hh, o, scale=0.01), act(n, hh, hh, o, scale=3.0)
        ds = torch.randn((S, o), device=dev, generator=gen) * 1e-4
        dq = torch.randn((S, o), device=dev, generator=gen) * 1e-6
        px = n * hh * hh
        sites.append(Site("g_eff", f"{label} @{hh}x{hh} B={BIG_B}: y {o} ch",
                          lambda g=g, y=y, ds=ds, dq=dq: K.g_eff(g, y, ds, dq),
                          lambda g=g, y=y, ds=ds, dq=dq: K.g_eff_plain(g, y, ds, dq),
                          True, 3.0 * px * o, 3 * _nbytes(((n, hh, hh, o), 2)),
                          seq=lambda g=g, y=y, ds=ds, dq=dq: g_eff_seq(g, y, ds, dq),
                          seq_label="bf16_seq_ms"))
    for label, hh, c in (("in_conv output x1s 21 ch", HW, F),
                         ("down1 output 42 ch", h2, 2 * F)):
        y2, dz = act(n, hh, hh, c, scale=3.0), act(n, hh, hh, c, scale=0.01)
        sites += k8_sites(f"{label} @{hh}x{hh} B={BIG_B}", y2, dz, *affine(c), n, hh, hh, c)
    sites += prelu_sites(act, n, HW, HW, S, affine, gen, dev,
                         f"decoder bn2 + ReLU + out-conv 21->2 @256 B={BIG_B}")
    return sites


def prelu_sites(act, n, hh, ww, groups, affine, gen, dev, label, f=F, oc=2):
    """K12 forward and backward on a [n, hh, ww, f] decoder output with
    [groups, f] affines and ``oc`` outputs: the backward with its kernel
    and reduce_groups parts and its eager bf16 sequence."""
    import torch
    from mimo_unet_torch import kernels as K

    px = n * hh * ww
    elem, logits = _nbytes(((n, hh, ww, f), 2)), _nbytes(((n, hh, ww, oc), 2))
    y6 = act(n, hh, ww, f, scale=3.0)
    sc6, sh6 = affine(f)
    wo = (torch.rand((groups, f, oc), device=dev, generator=gen) * 2 - 1) / f ** 0.5
    bo = torch.randn((groups, oc), device=dev, generator=gen) * 0.1
    gl_ = act(n, hh, ww, oc, scale=0.01)
    return [Site("conv1x1_prelu", label,
                 lambda: K.conv1x1_prelu(y6, sc6, sh6, wo, bo),
                 lambda: K.conv1x1_prelu_plain(y6, sc6, sh6, wo, bo),
                 False, px * (3.0 * f + 2.0 * f * oc), elem + logits,
                 seq=lambda: prelu_seq(y6, sc6, sh6, wo, bo), seq_label="bf16_seq_ms"),
            Site("conv1x1_prelu_bwd", label,
                 lambda: K.conv1x1_prelu_bwd(gl_, y6, sc6, sh6, wo),
                 lambda: K.conv1x1_prelu_bwd_plain(gl_, y6, sc6, sh6, wo),
                 False, px * (4.0 * f + 4.0 * f * oc), 2 * elem + logits,
                 seq=lambda: prelu_bwd_seq(gl_, y6, sc6, sh6, wo), seq_label="bf16_seq_ms",
                 parts=prelu_bwd_parts(gl_, y6, sc6, sh6, wo))]


def train_sites(dev, gen, s=S, f=F, oc=2, tag="", cin=3, b=TB, hw=NYU):
    """The train kernels at their call sites of
    mimo_unet_torch/models/fast_path.py ``mimo_unet_apply_train`` at
    640x480, B=4 (n = S*B images, S-major); down1's at half resolution.
    The flagship's widths, or ``s`` subnetworks of ``f`` filters, ``cin``
    input channels and ``oc`` outputs, ``b`` images of size ``hw``, each
    label prefixed with ``tag`` (and, off 640x480 B=4, suffixed with the
    size)."""
    import torch
    import torch.nn.functional as Fn
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    n = s * b
    th, tw = hw
    at = "" if (b, hw) == (TB, NYU) else f" @{th}x{tw} B={b}"
    c_up = f * s
    mid = (f + c_up) // 2

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    def weight(cin, o):
        return ((torch.rand((s, 3, 3, cin, o), device=dev, generator=gen) * 2 - 1)
                / (9 * cin) ** 0.5).to(bf).float()

    def affine(c):
        return (torch.rand((s, c), device=dev, generator=gen) + 0.5,
                torch.randn((s, c), device=dev, generator=gen) * 0.1)

    def lib_in(x1, x2=None):
        """The site's inputs as one NCHW (channels-last) tensor with the S
        groups on channels, reflect-padded: [B, S*C, H+2, W+2]."""
        hh, ww = x1.shape[1:3]
        z = x1.view(s, b, hh, ww, -1)
        if x2 is not None:
            z = torch.cat([z, x2.unsqueeze(0).expand(s, *x2.shape)], dim=-1)
        z = z.permute(1, 0, 4, 2, 3).reshape(b, -1, hh, ww)
        return Fn.pad(z, (1, 1, 1, 1), mode="reflect").contiguous(
            memory_format=torch.channels_last)

    def lib_w(w):  # [S, 3, 3, C, O] -> [S*O, C, 3, 3] bf16
        return w.permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], 3, 3).to(bf)

    def lib_g(g):  # [S*B, H, W, O] -> [B, S*O, H, W]
        hh, ww = g.shape[1:3]
        return g.view(s, b, hh, ww, -1).permute(1, 0, 4, 2, 3).reshape(
            b, -1, hh, ww).contiguous(memory_format=torch.channels_last)

    sites = []
    # (label, x1, x2, w, prologue) per conv of the path; down1's conv1 is
    # the one without a prologue whose input needs a gradient (plain dx)
    h2, w2 = th // 2, tw // 2
    x = act(n, th, tw, cin)
    y1, x1s, y5 = act(n, th, tw, f), act(n, th, tw, f), act(n, th, tw, mid)
    p1, y3 = act(n, h2, w2, f), act(n, h2, w2, 2 * f)
    up = act(b, th, tw, c_up)
    convs = [
        (f"{tag}in_conv.conv1 {cin}->{f}{at}", x, None, weight(cin, f), None),
        (f"{tag}in_conv.conv2 {f}->{f} +prologue{at}", y1, None, weight(f, f), affine(f)),
        (f"{tag}down1.conv1 {f}->{2 * f} @{w2}x{h2}{at}", p1, None, weight(f, 2 * f), None),
        (f"{tag}down1.conv2 {2 * f}->{2 * f} +prologue @{w2}x{h2}{at}", y3, None,
         weight(2 * f, 2 * f), affine(2 * f)),
        (f"{tag}decoder conv1 ({f}+{c_up})->{mid} x2 period {b}{at}", x1s, up,
         weight(f + c_up, mid), None),
        (f"{tag}decoder conv2 {mid}->{f} +prologue{at}", y5, None, weight(mid, f), affine(mid)),
    ]
    for label, a1, a2, w, pro in convs:
        sc, sh = pro if pro is not None else (None, None)
        c1, cin, o = a1.shape[-1], w.shape[3], w.shape[4]
        hh, ww = a1.shape[1:3]
        cpx = n * hh * ww
        n2 = 0 if a2 is None else a2.shape[0]
        conv_flops = 2.0 * cpx * 9 * cin * o
        in_bytes = _nbytes((a1.shape, 2)) + (0 if a2 is None else _nbytes((a2.shape, 2)))
        w_bytes = _nbytes((w.shape, 2))
        y_bytes = _nbytes(((n, hh, ww, o), 2))
        g = act(n, hh, ww, o, scale=0.01)
        ds = torch.randn((s, o), device=dev, generator=gen) * 1e-4
        dq = torch.randn((s, o), device=dev, generator=gen) * 1e-6
        xl, wl = lib_in(a1, a2), lib_w(w)
        gl = lib_g(g)
        sites.append(Site(
            "conv3x3_fwd", label,
            lambda a1=a1, a2=a2, w=w, sc=sc, sh=sh: K.conv3x3_fwd(a1, w, x2=a2, scale=sc, shift=sh),
            lambda a1=a1, a2=a2, w=w, sc=sc, sh=sh: K.conv3x3_fwd_plain(a1, w, x2=a2, scale=sc, shift=sh),
            False, conv_flops, in_bytes + w_bytes + y_bytes,
            lambda xl=xl, wl=wl: Fn.conv2d(xl, wl, groups=s)))
        yk = K.conv3x3_fwd(a1, w, x2=a2, scale=sc, shift=sh)[0]
        sites.append(Site(
            "g_eff", f"{label}: y {o} ch",
            lambda g=g, yk=yk, ds=ds, dq=dq: K.g_eff(g, yk, ds, dq),
            lambda g=g, yk=yk, ds=ds, dq=dq: K.g_eff_plain(g, yk, ds, dq),
            True, 3.0 * cpx * o, 3 * y_bytes,
            seq=lambda g=g, yk=yk, ds=ds, dq=dq: g_eff_seq(g, yk, ds, dq),
            seq_label="bf16_seq_ms"))
        dx_shape = (b, s * cin, hh, ww)
        if a2 is not None:
            sites.append(Site(
                "conv3x3_dx_fold", label,
                lambda g=g, w=w, c1=c1, n2=n2: K.conv3x3_dx_fold(g, w, c1, n2),
                lambda g=g, w=w, c1=c1, n2=n2: K.conv3x3_dx_fold_plain(g, w, c1, n2),
                False, conv_flops, y_bytes + w_bytes + in_bytes,
                lambda gl=gl, wl=wl, dx_shape=dx_shape: torch.nn.grad.conv2d_input(
                    dx_shape, wl, gl, padding=1, groups=s)))
        elif sc is not None or a1 is p1:  # down1's input needs its gradient
            sites.append(Site(
                "conv3x3_dx", label,
                lambda g=g, w=w, a1=a1, sc=sc, sh=sh: K.conv3x3_dx(g, w, x1=a1, scale=sc, shift=sh),
                lambda g=g, w=w, a1=a1, sc=sc, sh=sh: K.conv3x3_dx_plain(g, w, x1=a1, scale=sc, shift=sh),
                False, conv_flops,
                y_bytes + w_bytes + (1 if sc is None else 2) * in_bytes,
                lambda gl=gl, wl=wl, dx_shape=dx_shape: torch.nn.grad.conv2d_input(
                    dx_shape, wl, gl, padding=1, groups=s)))
        sites.append(Site(
            "conv3x3_dw", label,
            lambda g=g, a1=a1, a2=a2, sc=sc, sh=sh: K.conv3x3_dw(g, a1, s, x2=a2, scale=sc, shift=sh),
            lambda g=g, a1=a1, a2=a2, sc=sc, sh=sh: K.conv3x3_dw_plain(g, a1, s, x2=a2, scale=sc, shift=sh),
            False, conv_flops,
            in_bytes + y_bytes + _nbytes((w.shape, 4)),
            lambda xl=xl, wl=wl, gl=gl: torch.nn.grad.conv2d_weight(
                xl, wl.shape, gl, groups=s)))

    for label, hh, ww, c in ((f"{tag}in_conv output x1s {f} ch{at}", th, tw, f),
                             (f"{tag}down1 output {2 * f} ch @{w2}x{h2}{at}", h2, w2, 2 * f)):
        y2 = act(n, hh, ww, c, scale=3.0)
        sc2, sh2 = affine(c)
        sites += k8_sites(label, y2, act(n, hh, ww, c, scale=0.01), sc2, sh2, n, hh, ww, c)
    return sites + prelu_sites(act, n, th, tw, s, affine, gen, dev,
                               f"{tag}decoder bn2 + ReLU + out-conv {f}->{oc}{at}", f=f, oc=oc)


def dropout_kernel_sites(dev, gen):
    """K11 at its call sites (models/fast_path.py: the MC-dropout eval
    decoder, N = S*8*4 at 256x256; the final-dropout train decoder, N = S*4
    at 640x480) and K8/K12 with per-image parameters (groups = N) at their
    640x480 B=4 and 256x256 B=64 train sites, as the Dropout2d sites fold
    into them."""
    import torch
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    sites = []

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    def out_conv(groups):
        return ((torch.rand((groups, F, 2), device=dev, generator=gen) * 2 - 1) / F ** 0.5,
                torch.randn((groups, 2), device=dev, generator=gen) * 0.1)

    def baddbmm(z, wo, bo):  # one library call of the grouped 1x1
        g = wo.shape[0]
        return torch.baddbmm(bo.to(bf)[:, None, :], z.view(g, -1, z.shape[-1]),
                             wo.to(bf))

    def baddbmm_backward(g, z, wo, bo):  # its autograd backward, z, wo and bo
        args = [t.detach().requires_grad_() for t in (z, wo.to(bf), bo.to(bf))]
        out = baddbmm(*args)
        gl = g.view(out.shape)
        return lambda: torch.autograd.grad(out, args, gl, retain_graph=True)

    n_mc = S * MC_B * MC_STEPS
    z = act(n_mc, HW, HW, F)
    wo, bo = out_conv(S)
    px = n_mc * HW * HW
    sites.append(Site("conv1x1", f"MC decoder 21->2, N={n_mc} @256",
                      lambda: K.conv1x1(z, wo, bo), lambda: K.conv1x1_plain(z, wo, bo),
                      False, 2.0 * px * F * 2,
                      _nbytes((z.shape, 2), ((n_mc, HW, HW, 2), 2)),
                      lambda: baddbmm(z, wo, bo)))

    n, px = S * TB, S * TB * TH * TW
    elem, logits = _nbytes(((n, TH, TW, F), 2)), _nbytes(((n, TH, TW, 2), 2))
    zt = act(n, TH, TW, F)
    gt = act(n, TH, TW, 2, scale=0.01)
    sites.append(Site("conv1x1", f"final-dropout decoder 21->2, N={n} @640x480",
                      lambda: K.conv1x1(zt, wo, bo), lambda: K.conv1x1_plain(zt, wo, bo),
                      False, 2.0 * px * F * 2, elem + logits,
                      lambda: baddbmm(zt, wo, bo)))
    sites.append(Site("conv1x1_bwd", f"final-dropout decoder 21->2, N={n} @640x480",
                      lambda: K.conv1x1_bwd(gt, zt, wo),
                      lambda: K.conv1x1_bwd_plain(gt, zt, wo),
                      False, px * (4.0 * F * 2 + 2), 2 * elem + logits,
                      baddbmm_backward(gt, zt, wo, bo), parts=conv1x1_bwd_parts(gt, zt, wo)))

    def per_image_affine(n, b):
        """The per-group BN affine times each image's Dropout2d scale (0 or
        1/keep): [n, F], n = S * b."""
        keep = 0.9
        m = (torch.rand((n, F), device=dev, generator=gen) < keep).float() / keep
        return ((torch.rand((S, F), device=dev, generator=gen) + 0.5).repeat_interleave(b, 0) * m,
                (torch.randn((S, F), device=dev, generator=gen) * 0.1).repeat_interleave(b, 0) * m)

    sc, sh = per_image_affine(n, TB)
    y = act(n, TH, TW, F, scale=3.0)
    dz = act(n, TH, TW, F, scale=0.01)
    wo_i, bo_i = wo.repeat_interleave(TB, 0), bo.repeat_interleave(TB, 0)
    sites += k8_sites(f"in_conv x1s 21 ch, groups={n}", y, dz, sc, sh, n, TH, TW, F)
    sites.append(Site("conv1x1_prelu", f"decoder up4 Dropout2d + out-conv, groups={n}",
                      lambda: K.conv1x1_prelu(y, sc, sh, wo_i, bo_i),
                      lambda: K.conv1x1_prelu_plain(y, sc, sh, wo_i, bo_i),
                      False, px * (3.0 * F + 2.0 * F * 2), elem + logits,
                      seq=lambda: prelu_seq(y, sc, sh, wo_i, bo_i), seq_label="bf16_seq_ms"))
    sites.append(Site("conv1x1_prelu_bwd", f"decoder up4 Dropout2d + out-conv, groups={n}",
                      lambda: K.conv1x1_prelu_bwd(gt, y, sc, sh, wo_i),
                      lambda: K.conv1x1_prelu_bwd_plain(gt, y, sc, sh, wo_i),
                      False, px * (4.0 * F + 4.0 * F * 2), 2 * elem + logits,
                      seq=lambda: prelu_bwd_seq(gt, y, sc, sh, wo_i), seq_label="bf16_seq_ms",
                      parts=prelu_bwd_parts(gt, y, sc, sh, wo_i)))

    # the same per-image sites of the flagship 256x256 step at B=64
    nb = S * BIG_B
    yb, dzb = act(nb, HW, HW, F, scale=3.0), act(nb, HW, HW, F, scale=0.01)
    scb, shb = per_image_affine(nb, BIG_B)
    sites += k8_sites(f"in_conv x1s 21 ch, groups={nb} @256", yb, dzb, scb, shb,
                      nb, HW, HW, F)
    return sites + prelu_sites(act, nb, HW, HW, nb,
                               lambda c: per_image_affine(nb, BIG_B), gen, dev,
                               f"decoder up4 Dropout2d + out-conv, groups={nb} @256")


def resample_sites(dev, gen, s=S, f=F, steps=((BIG_B, PATCH), (TB, NYU)), prefix=""):
    """K10 and K13 at their train call sites (models/fast_path.py
    ``mimo_unet_apply_train``): the flagship 256x256 step at B=64 (N = S*B
    = 128 images) and the 640x480 step at B=4 (or ``s`` subnetworks of
    ``f`` filters at the ``steps`` (B, size), each label prefixed with
    ``prefix``).  The pool's input is a ReLU
    output, so all-zero windows tie; the pool's backward runs with the
    skip cotangent, as both sites run it, and once without at 640x480.
    Library calls: ``F.max_pool2d`` and ``F.interpolate`` (bilinear,
    align_corners) on the channels-last tensor, and their autograd
    backward."""
    import torch
    import torch.nn.functional as Fn
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16

    def act(*shape, relu=False):
        t = torch.randn(shape, device=dev, generator=gen)
        return (t.clamp_min(0) if relu else t).to(bf)

    def nchw(t):  # an NCHW view of a channels-last tensor
        return t.permute(0, 3, 1, 2)

    def backward_of(fn, x, g):
        """One library backward: autograd of ``fn`` at x against g."""
        xl = nchw(x).detach().requires_grad_()
        out, gl = fn(xl), nchw(g)
        return lambda: torch.autograd.grad(out, xl, gl, retain_graph=True)

    def pool(t):
        return Fn.max_pool2d(t, 2)

    def interp(t):
        return Fn.interpolate(t, scale_factor=2, mode="bilinear", align_corners=True)

    sites = []
    for b, (h, w) in steps:
        n, tag = s * b, f"{h}x{w} B={b}"
        for label, c, hh, ww in ((f"{prefix}in_conv -> down1", f, h, w),
                                 (f"{prefix}down1 -> core", 2 * f, h // 2, w // 2)):
            x = act(n, hh, ww, c, relu=True)
            y, g, gs = K.max_pool2x2(x), act(n, hh // 2, ww // 2, c), act(n, hh, ww, c)
            full = _nbytes(((n, hh, ww, c), 2))
            half = full / 4
            sites.append(Site(
                "max_pool2x2", f"{label} {tag} [{n},{hh},{ww},{c}]",
                lambda x=x: K.max_pool2x2(x), lambda x=x: K.max_pool2x2_plain(x),
                True, 0.75 * x.numel(), full + half, lambda x=x: pool(nchw(x))))
            sites.append(Site(
                "max_pool2x2_bwd", f"{label} {tag} +skip",
                lambda g=g, x=x, y=y, gs=gs: K.max_pool2x2_bwd(g, x, y, gs),
                lambda g=g, x=x, y=y, gs=gs: K.max_pool2x2_bwd_plain(g, x, y, gs),
                True, 2.0 * x.numel(), 3 * full + 2 * half, backward_of(pool, x, g)))
            if b == TB and c == 2 * f:
                sites.append(Site(
                    "max_pool2x2_bwd", f"{label} {tag} no skip",
                    lambda g=g, x=x, y=y: K.max_pool2x2_bwd(g, x, y),
                    lambda g=g, x=x, y=y: K.max_pool2x2_bwd_plain(g, x, y),
                    True, 1.0 * x.numel(), 2 * full + 2 * half, backward_of(pool, x, g)))
        c_up = f * s  # the core's output channels
        xu, gu = act(b, h // 2, w // 2, c_up), act(b, h, w, c_up)
        big = _nbytes((gu.shape, 2))
        sites.append(Site(
            "upsample2x", f"{prefix}decoder input {tag} [{b},{h // 2},{w // 2},{c_up}]",
            lambda xu=xu: K.upsample2x(xu), lambda xu=xu: K.upsample2x_plain(xu),
            True, 9.0 * gu.numel(), 1.25 * big, lambda xu=xu: interp(nchw(xu))))
        sites.append(Site(
            "upsample2x_bwd", f"{prefix}decoder input {tag}",
            lambda gu=gu: K.upsample2x_bwd(gu), lambda gu=gu: K.upsample2x_bwd_plain(gu),
            True, 7.5 * gu.numel(), 1.25 * big, backward_of(interp, xu, gu)))
    return sites


def tail_sites(dev, gen):
    """The train kernels at shapes their blocks do not divide: down1 of a
    48x48 step at B=3 (N = 6 images of 24x24 = 576 pixels: 1.5 of the
    conv kernels' 16-column tiles per image row, 6.75 of the reducing
    passes' 256-pixel blocks per group, 2.25 per image at groups = N) with
    fbc 40's 40 -> 80 channels, K5/K6/K7 at H = W = 3, 4, 5 and 24 with
    fbc 40's in_conv and decoder widths, and the 1x1 kernels at that pixel
    count."""
    import torch
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    n, hh, ww, f = S * 3, 24, 24, 40

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    def weight(cin, o):
        return ((torch.rand((S, 3, 3, cin, o), device=dev, generator=gen) * 2 - 1)
                / (9 * cin) ** 0.5).to(bf).float()

    def affine(groups, c):
        return (torch.rand((groups, c), device=dev, generator=gen) + 0.5,
                torch.randn((groups, c), device=dev, generator=gen) * 0.1)

    sites = []

    def add(name, label, kern, plain):
        sites.append(Site(name, label, kern, plain, False, 0.0, 0.0))

    p1, y3, x1s = act(n, hh, ww, f), act(n, hh, ww, 2 * f), act(n, hh, ww, 8)
    up = act(n // S, hh, ww, 16)
    w1, w2, wd = weight(f, 2 * f), weight(2 * f, 2 * f), weight(24, 12)
    sc, sh = affine(S, 2 * f)
    g1, gd = act(n, hh, ww, 2 * f, scale=0.01), act(n, hh, ww, 12, scale=0.01)
    tag = f"[{n},{hh},{ww}]"
    add("conv3x3_fwd", f"down1.conv1 40->80 {tag}",
        lambda: K.conv3x3_fwd(p1, w1), lambda: K.conv3x3_fwd_plain(p1, w1))
    add("conv3x3_fwd", f"down1.conv2 80->80 +prologue {tag}",
        lambda: K.conv3x3_fwd(y3, w2, scale=sc, shift=sh),
        lambda: K.conv3x3_fwd_plain(y3, w2, scale=sc, shift=sh))
    add("conv3x3_dx", f"down1.conv1 {tag}",
        lambda: K.conv3x3_dx(g1, w1), lambda: K.conv3x3_dx_plain(g1, w1))
    add("conv3x3_dx", f"down1.conv2 +prologue {tag}",
        lambda: K.conv3x3_dx(g1, w2, x1=y3, scale=sc, shift=sh),
        lambda: K.conv3x3_dx_plain(g1, w2, x1=y3, scale=sc, shift=sh))
    add("conv3x3_dx_fold", f"(8+16)->12 x2 period {n // S} {tag}",
        lambda: K.conv3x3_dx_fold(gd, wd, 8, n // S),
        lambda: K.conv3x3_dx_fold_plain(gd, wd, 8, n // S))
    add("conv3x3_dw", f"down1.conv1 {tag}",
        lambda: K.conv3x3_dw(g1, p1, S), lambda: K.conv3x3_dw_plain(g1, p1, S))
    add("conv3x3_dw", f"down1.conv2 +prologue {tag}",
        lambda: K.conv3x3_dw(g1, y3, S, scale=sc, shift=sh),
        lambda: K.conv3x3_dw_plain(g1, y3, S, scale=sc, shift=sh))
    # K5/K6/K7 at H = W = 3, 4, 5 (one partial tile; at 3 the row and
    # column reflect folds of both edges land on pixel 1) and 24, with fbc
    # 40's in_conv and decoder widths: 3 -> 40, 40 -> 40, (40 + 80) -> 60
    # (x2 shared by the S groups; x2_half_h at even H), 60 -> 40
    for e in (3, 4, 5, 24):
        b2 = 2
        m = S * b2
        tg = f"[{m},{e},{e}] fbc 40"
        xin, x1d, y5 = act(m, e, e, 3), act(m, e, e, f), act(m, e, e, 60)
        xu = act(b2, e, e, 2 * f)
        gf, g60 = act(m, e, e, f, scale=0.01), act(m, e, e, 60, scale=0.01)
        wi, wf, wc1, wc2 = weight(3, f), weight(f, f), weight(3 * f, 60), weight(60, f)
        scf, shf = affine(S, f)
        s60, h60 = affine(S, 60)
        add("conv3x3_fwd", f"in_conv.conv1 3->40 {tg}",
            lambda xin=xin, wi=wi: K.conv3x3_fwd(xin, wi),
            lambda xin=xin, wi=wi: K.conv3x3_fwd_plain(xin, wi))
        add("conv3x3_fwd", f"in_conv.conv2 40->40 +prologue {tg}",
            lambda x1d=x1d, wf=wf, scf=scf, shf=shf:
                K.conv3x3_fwd(x1d, wf, scale=scf, shift=shf),
            lambda x1d=x1d, wf=wf, scf=scf, shf=shf:
                K.conv3x3_fwd_plain(x1d, wf, scale=scf, shift=shf))
        add("conv3x3_fwd", f"decoder conv1 (40+80)->60 {tg}",
            lambda x1d=x1d, xu=xu, wc1=wc1: K.conv3x3_fwd(x1d, wc1, x2=xu),
            lambda x1d=x1d, xu=xu, wc1=wc1: K.conv3x3_fwd_plain(x1d, wc1, x2=xu))
        add("conv3x3_fwd", f"decoder conv2 60->40 +prologue {tg}",
            lambda y5=y5, wc2=wc2, s60=s60, h60=h60:
                K.conv3x3_fwd(y5, wc2, scale=s60, shift=h60),
            lambda y5=y5, wc2=wc2, s60=s60, h60=h60:
                K.conv3x3_fwd_plain(y5, wc2, scale=s60, shift=h60))
        add("conv3x3_dw", f"in_conv.conv1 3->40 {tg}",
            lambda gf=gf, xin=xin: K.conv3x3_dw(gf, xin, S),
            lambda gf=gf, xin=xin: K.conv3x3_dw_plain(gf, xin, S))
        add("conv3x3_dx", f"in_conv.conv2 40->40 +prologue {tg}",
            lambda gf=gf, wf=wf, x1d=x1d, scf=scf, shf=shf:
                K.conv3x3_dx(gf, wf, x1=x1d, scale=scf, shift=shf),
            lambda gf=gf, wf=wf, x1d=x1d, scf=scf, shf=shf:
                K.conv3x3_dx_plain(gf, wf, x1=x1d, scale=scf, shift=shf))
        add("conv3x3_dw", f"in_conv.conv2 40->40 +prologue {tg}",
            lambda gf=gf, x1d=x1d, scf=scf, shf=shf:
                K.conv3x3_dw(gf, x1d, S, scale=scf, shift=shf),
            lambda gf=gf, x1d=x1d, scf=scf, shf=shf:
                K.conv3x3_dw_plain(gf, x1d, S, scale=scf, shift=shf))
        add("conv3x3_dx_fold", f"decoder conv1 (40+80)->60 {tg}",
            lambda g60=g60, wc1=wc1: K.conv3x3_dx_fold(g60, wc1, f, b2),
            lambda g60=g60, wc1=wc1: K.conv3x3_dx_fold_plain(g60, wc1, f, b2))
        add("conv3x3_dw", f"decoder conv1 (40+80)->60 {tg}",
            lambda g60=g60, x1d=x1d, xu=xu: K.conv3x3_dw(g60, x1d, S, x2=xu),
            lambda g60=g60, x1d=x1d, xu=xu: K.conv3x3_dw_plain(g60, x1d, S, x2=xu))
        if e % 2 == 0:
            xh = act(b2, e // 2, e, 2 * f)
            add("conv3x3_fwd", f"decoder conv1 (40+80)->60 x2_half_h {tg}",
                lambda x1d=x1d, xh=xh, wc1=wc1: K.conv3x3_fwd(x1d, wc1, x2=xh, x2_half_h=True),
                lambda x1d=x1d, xh=xh, wc1=wc1:
                    K.conv3x3_fwd_plain(x1d, wc1, x2=xh, x2_half_h=True))
            add("conv3x3_dw", f"decoder conv1 (40+80)->60 x2_half_h {tg}",
                lambda g60=g60, x1d=x1d, xh=xh:
                    K.conv3x3_dw(g60, x1d, S, x2=xh, x2_half_h=True),
                lambda g60=g60, x1d=x1d, xh=xh:
                    K.conv3x3_dw_plain(g60, x1d, S, x2=xh, x2_half_h=True))
        add("conv3x3_dx", f"decoder conv2 60->40 +prologue {tg}",
            lambda gf=gf, wc2=wc2, y5=y5, s60=s60, h60=h60:
                K.conv3x3_dx(gf, wc2, x1=y5, scale=s60, shift=h60),
            lambda gf=gf, wc2=wc2, y5=y5, s60=s60, h60=h60:
                K.conv3x3_dx_plain(gf, wc2, x1=y5, scale=s60, shift=h60))
        add("conv3x3_dw", f"decoder conv2 60->40 +prologue {tg}",
            lambda gf=gf, y5=y5, s60=s60, h60=h60:
                K.conv3x3_dw(gf, y5, S, scale=s60, shift=h60),
            lambda gf=gf, y5=y5, s60=s60, h60=h60:
                K.conv3x3_dw_plain(gf, y5, S, scale=s60, shift=h60))
    y4, dz = act(n, hh, ww, 2 * f, scale=3.0), act(n, hh, ww, 2 * f, scale=0.01)
    z, gl = act(n, hh, ww, f, scale=3.0), act(n, hh, ww, 2, scale=0.01)
    y1, dz1 = act(n, 2 * hh, 2 * ww, f, scale=3.0), act(n, 2 * hh, 2 * ww, f, scale=0.01)
    for groups in (S, n):
        sc4, sh4 = affine(groups, 2 * f)
        sc1, sh1 = affine(groups, f)
        # K8 at in_conv's (40 ch, 48x48) and down1's (80 ch, 24x24) outputs
        sites.extend(k8_sites(f"in_conv 40 ch, groups={groups} [{n},{2 * hh},{2 * ww}]",
                              y1, dz1, sc1, sh1, n, 2 * hh, 2 * ww, f))
        sites.extend(k8_sites(f"down1 80 ch, groups={groups} {tag}", y4, dz, sc4, sh4,
                              n, hh, ww, 2 * f))
        sc6, sh6 = affine(groups, f)
        wo = (torch.rand((groups, f, 2), device=dev, generator=gen) * 2 - 1) / f ** 0.5
        bo = torch.randn((groups, 2), device=dev, generator=gen) * 0.1
        add("conv1x1_prelu", f"40->2, groups={groups} {tag}",
            lambda sc6=sc6, sh6=sh6, wo=wo, bo=bo: K.conv1x1_prelu(z, sc6, sh6, wo, bo),
            lambda sc6=sc6, sh6=sh6, wo=wo, bo=bo: K.conv1x1_prelu_plain(z, sc6, sh6, wo, bo))
        add("conv1x1_prelu_bwd", f"40->2, groups={groups} {tag}",
            lambda sc6=sc6, sh6=sh6, wo=wo: K.conv1x1_prelu_bwd(gl, z, sc6, sh6, wo),
            lambda sc6=sc6, sh6=sh6, wo=wo: K.conv1x1_prelu_bwd_plain(gl, z, sc6, sh6, wo))
        add("conv1x1", f"40->2, groups={groups} {tag}",
            lambda wo=wo, bo=bo: K.conv1x1(z, wo, bo),
            lambda wo=wo, bo=bo: K.conv1x1_plain(z, wo, bo))
        add("conv1x1_bwd", f"40->2, groups={groups} {tag}",
            lambda wo=wo: K.conv1x1_bwd(gl, z, wo),
            lambda wo=wo: K.conv1x1_bwd_plain(gl, z, wo))
    # K13 at the 48x48 step's decoder input (fbc 40: 80 channels, 24x24
    # from 12x12, B=3), and at a row longer than one tile of either
    # kernel (W = 64 at 80 channels), bitwise
    for b, e in ((3, 12), (2, 32)):
        xu, gu = act(b, e, e, 2 * f), act(b, 2 * e, 2 * e, 2 * f)
        sites.append(Site("upsample2x", f"decoder input fbc 40 [{b},{e},{e},{2 * f}]",
                          lambda xu=xu: K.upsample2x(xu), lambda xu=xu: K.upsample2x_plain(xu),
                          True, 0.0, 0.0))
        sites.append(Site("upsample2x_bwd", f"decoder input fbc 40 [{b},{2 * e},{2 * e},{2 * f}]",
                          lambda gu=gu: K.upsample2x_bwd(gu),
                          lambda gu=gu: K.upsample2x_bwd_plain(gu), True, 0.0, 0.0))
    return sites


def _timed(fn, iters):
    """``device_ms`` of ``fn`` as (ms, text): the text names the method
    where the calls were not timed queued behind a device-side wait."""
    ms, how = device_ms(fn, iters)
    return ms, f"{ms:.4f} ms" + ("" if how == "queued" else f" [{how}]")


SITE_MS = {}  # device ms of every site check_kernels timed, by (kernel, site)


def check_kernels(sites, card):
    """Every site's kernel against its plain version; returns per-kernel
    {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms}, the
    times summed over the call sites.  Every time is device time
    (``device_ms``); the kernel's is also printed as CUDA events around
    back-to-back calls (``events_ms``), the method before, which reads the
    host where a call's launch outlasts its kernel."""
    import torch

    stats = {}
    for st in sites:
        got = st.kern()
        torch.cuda.synchronize()
        err = compare(f"{st.name} [{st.site}]", got, st.plain(), st.exact)
        if st.repeat:
            compare(f"{st.name} [{st.site}] launch to launch", st.kern(), got, True)
        del got
        iters = 20 if st.exact else 5
        (ms, ms_t), (plain_ms, plain_t) = _timed(st.kern, iters), _timed(st.plain, iters)
        ev_ms = events_ms(st.kern, iters)
        lib_ms, lib_t = _timed(st.library, iters) if st.library is not None else (None, "")
        seq_ms, seq_t = _timed(st.seq, iters) if st.seq is not None else (None, "")
        t_ops, t_bytes = st.flops / PEAK_FLOPS * 1e3, st.nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        rec = stats.setdefault(st.name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": None, "library_ms": None, "_ops_ms": 0.0, "_bytes_ms": 0.0})
        SITE_MS[(st.name, st.site)] = ms
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
        rec["bound_ms"] += bound
        rec["_ops_ms"] += t_ops
        rec["_bytes_ms"] += t_bytes
        if lib_ms is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + lib_ms
        lib = f", library {lib_t}" if lib_ms is not None else ""
        old = f" (before its redesign {st.before} ms, PERF.md)" if st.before else ""
        rpt = ", launch to launch bitwise" if st.repeat else ""
        seq = f", {st.seq_label} {seq_t}" if seq_ms is not None else ""
        if st.parts is not None:
            old += " (" + " + ".join(f"{k} {_timed(fn, iters)[1]}"
                                     for k, fn in st.parts.items()) + ")"
        print(f"kernel {st.name} [{st.site}]: max_abs_err {err} "
              f"({_mode(st.exact)}{rpt}), device {ms_t}{old}, events {ev_ms:.4f} ms vs "
              f"plain {plain_t}{lib}{seq}, bound {bound:.4f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}) ({card})",
              flush=True)
    for rec in stats.values():
        rec["bound_by"] = "bytes" if rec.pop("_bytes_ms") >= rec.pop("_ops_ms") else "operations"
    return stats


def _tc_marked(sites):
    """Tensor-core kernel sites (K1/K2, K5/K6/K7) with their CUDA-core
    kernels' time and the launch-to-launch check."""
    for st in sites:
        if st.name in TC_KERNELS:
            st.repeat = True
            st.before = next((v for (k, lab), v in CUDA_CORE_MS.items()
                              if k == st.name and st.site.startswith(lab)), None)
    return sites


def tensor_core_report():
    """Print ptxas's registers, shared memory and spills of the tensor-core
    kernels (this build's nvcc -Xptxas -v: the train convs and the fused
    DoubleConv) and of train_elem.cu's, upsample2x.cu's and
    upsample_w2x.cu's kernels, and the HMMA (tensor-core mma) instructions of each in the
    library's SASS (cuobjdump, where the toolkit has it); raise if K5, K6,
    K7 or K1/K2 has none."""
    import re
    import shutil
    from mimo_unet_torch.kernels import _build

    for stem in ("conv3x3_train", "fused_double_conv", "train_elem", "upsample2x",
                 "upsample_w2x"):
        fn = None
        for line in _build.build_log.get(stem, "").splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif fn and ("registers" in line or "spill" in line):
                print(f"ptxas {fn}: {line.split(':', 1)[-1].strip()}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("cuobjdump: not in this toolkit; HMMA count not measured")
        return
    sass = subprocess.run([tool, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    for kern in ("conv_fwd_tc", "conv_dx_tc", "conv_dw_tc", "fused_double_conv_tc"):
        got = {k: v for k, v in counts.items() if kern in k}
        print(f"SASS HMMA instructions in {kern}: {sorted(got.values())}")
        if not got or min(got.values()) == 0:
            raise AssertionError(f"{kern}: no tensor-core (HMMA) instructions")


def _flagship(dev, s=S, f=F, **rates):
    """The flagship serving task (S=2, fbc=21, bf16, Laplace NLL; or ``s``
    subnetworks of ``f`` filters) with dropout ``rates`` and its model:
    seeded weights, random BatchNorm statistics."""
    import torch
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=s,
                        filter_base_count=f, loss="laplace_nll",
                        compute_dtype="bfloat16", **rates)
    cpu_gen = torch.Generator().manual_seed(1)
    model = task.build_model(dev, cpu_gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.weight.copy_(torch.rand(c, generator=cpu_gen) + 0.5)
                mod.bias.copy_(torch.randn(c, generator=cpu_gen) * 0.1)
                mod.running_mean.copy_(torch.randn(c, generator=cpu_gen) * 0.1)
                mod.running_var.copy_(torch.rand(c, generator=cpu_gen) + 0.5)
    return task, model


def _plain_copy(task, model, dev):
    """The same model on the plain modules (ct_kernels="off")."""
    off_task = dataclasses.replace(task, ct_kernels="off")
    off_model = off_task.build_model(dev)
    off_model.load_state_dict(model.state_dict())
    return off_task, off_model


def serve(dev, card):
    """The flagship served through an Ensemble; returns the eval kernels'
    launch counts over the requests."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.ensemble import Ensemble

    task, model = _flagship(dev)
    ens = Ensemble([(task, model)])
    rng = torch.Generator().manual_seed(2)
    requests = [torch.rand((B, HW, HW, 3), generator=rng).numpy()
                for _ in range(3)]
    requests.append(torch.rand((1, HW, HW, 3), generator=rng).numpy())

    for req in (requests[0], requests[-1]):  # warm-up: cuDNN plans per shape
        ens.predict(req, batch_size=req.shape[0])
    torch.cuda.synchronize()
    K.reset_launch_counts()
    answers = []
    for req in requests:
        t0 = time.perf_counter()
        answers.append(ens.predict(req, batch_size=req.shape[0]))
        dt = time.perf_counter() - t0
        print(f"predict B={req.shape[0]}: {dt * 1e3:.3f} ms, "
              f"{req.shape[0] / dt:.1f} patches/s ({card})")
    launches = K.launch_counts()
    print(f"serve launches: {launches}")
    missing = [k.__name__ for k in K.EVAL_KERNELS if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")

    _hold_to_plain(Ensemble([_plain_copy(task, model, dev)]), requests, answers, "serve")
    return launches


def _hold_to_plain(off, requests, answers, tag):
    """Each answer finite, of its request's shape, variances >= 0, and
    within 3e-2 * max|ref| of the plain ensemble ``off``'s."""
    import torch

    for req, (mean, ale, epi) in zip(requests, answers):
        for name, arr in (("mean", mean), ("aleatoric", ale), ("epistemic", epi)):
            if arr.shape != (req.shape[0], HW, HW, 1):
                raise AssertionError(f"{tag} {name}: shape {arr.shape}")
            if not torch.isfinite(torch.from_numpy(arr)).all():
                raise AssertionError(f"{tag} {name}: non-finite values")
        if (ale < 0).any() or (epi < 0).any():
            raise AssertionError(f"{tag}: negative variance")
        ref_mean, ref_ale, ref_epi = off.predict(req, batch_size=req.shape[0])
        # the epistemic variance of near-equal subnetwork predictions is the
        # square of a small difference: it is held as a standard deviation,
        # at the predictions' scale
        pred_scale = float(abs(ref_mean).max()) or 1.0
        for name, got, want, scale in (
                ("mean", mean, ref_mean, pred_scale),
                ("aleatoric var", ale, ref_ale, float(abs(ref_ale).max()) or 1.0),
                ("epistemic std", epi ** 0.5, ref_epi ** 0.5, pred_scale)):
            err = float(abs(got - want).max())
            print(f"{tag} B={req.shape[0]} {name}: max abs vs ct_kernels=off "
                  f"{err} (scale {scale})")
            if err > 3e-2 * scale:
                raise AssertionError(f"{tag} {name}: kernel path vs plain {err} > "
                                     f"3e-2 * {scale}")


def serve_baselines(dev, card):
    """BASELINE 5a (S=3, fbc 30) and 5b (S=4, fbc 30): one B=2 256x256
    ``predict`` each on the kernel route, whose counters must show K1 and
    K2, against the plain model."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.ensemble import Ensemble

    rng = torch.Generator().manual_seed(7)
    for tag, s5 in (("5a", 3), ("5b", 4)):
        task, model = _flagship(dev, s=s5, f=30)
        ens = Ensemble([(task, model)])
        req = torch.rand((2, HW, HW, 3), generator=rng).numpy()
        ens.predict(req, batch_size=2)  # warm-up: cuDNN plans
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        answer = ens.predict(req, batch_size=2)
        dt = time.perf_counter() - t0
        launches = K.launch_counts()
        print(f"{tag} predict B=2: {dt * 1e3:.3f} ms; launches {launches} ({card})")
        if launches["fused_double_conv"] != 3 or launches["fused_double_conv9"] != 1:
            raise AssertionError(f"{tag}: not on the kernel route: {launches}")
        _hold_to_plain(Ensemble([_plain_copy(task, model, dev)]), [req], [answer], tag)
        del task, model, ens
        torch.cuda.empty_cache()


def serve_profile(dev, card):
    """A torch.profiler table of one flagship B=32 forward
    (``Ensemble.raw_forward``): the device time of K2 and of K1 at each
    site (the fused kernel's launches in path order: in_conv, down1, up3,
    decoder), of pool_w and upsample_w2x, of the core (every other kernel
    between down1 and up3) and of the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mimo_unet_torch.models.ensemble import Ensemble

    task, model = _flagship(dev)
    ens = Ensemble([(task, model)])
    image = torch.rand((B, HW, HW, 3), device=dev, generator=torch.Generator(dev).manual_seed(8))
    ens.raw_forward(image)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ens.raw_forward(image)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and ev.time_range.elapsed_us() > 0),
                     key=lambda ev: ev.time_range.start)
    sites = ("K2 in_conv", "K1 down1", "K1 up3", "K1 decoder")
    parts = {k: 0.0 for k in sites + ("pool_w + upsample_w2x", "core", "rest")}
    fused = 0
    for ev in kernels:
        us = ev.time_range.elapsed_us()
        if "fused_double_conv_tc" in ev.name:
            parts[sites[min(fused, 3)]] += us
            fused += 1
        elif "pool_w" in ev.name or "upsample_w2x" in ev.name:
            parts["pool_w + upsample_w2x"] += us
        elif fused == 2:  # after down1, before up3
            parts["core"] += us
        else:
            parts["rest"] += us
    if fused != 4:
        raise AssertionError(f"serve profile: {fused} fused DoubleConv launches, not 4")
    busy = sum(parts.values()) / 1e3
    print(f"serve profile B={B} forward (profiled wall {wall:.1f} ms, device busy "
          f"{busy:.3f} ms): " + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in parts.items())
          + f" ({card})")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15,
                                    max_name_column_width=60))
    del task, model, ens


def serve_mc(dev, card):
    """Phase 8: MC-dropout serving; returns the launch counts over the
    requests."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.ensemble import Ensemble

    task, model = _flagship(dev, **MC_RECIPE)
    ens = Ensemble([(task, model)], monte_carlo_steps=MC_STEPS,
                   generator=torch.Generator(dev).manual_seed(3))
    rng = torch.Generator().manual_seed(4)
    sizes = [MC_B] * 5 + [1] * 5
    requests = [torch.rand((b, HW, HW, 3), generator=rng).numpy() for b in sizes]
    for b in (MC_B, 1):  # warm-up: cuDNN plans per shape
        ens.predict(requests[sizes.index(b)], batch_size=b)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    times = {MC_B: [], 1: []}
    answers = []
    for req in requests:
        t0 = time.perf_counter()
        answers.append(ens.predict(req, batch_size=req.shape[0]))
        times[req.shape[0]].append(time.perf_counter() - t0)
    launches = K.launch_counts()
    for b, ts in times.items():
        ts.sort()
        print(f"MC predict B={b} x {MC_STEPS} passes: median {ts[len(ts) // 2] * 1e3:.3f} ms "
              f"over {len(ts)} (min {ts[0] * 1e3:.3f}) ({card})")
    print(f"MC serve launches: {launches}")
    missing = [k.__name__ for k in K.EVAL_KERNELS + (K.conv1x1,)
               if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the MC serving path: {missing}")
    for req, outs in zip(requests, answers):
        for arr in outs:
            if (arr.shape != (req.shape[0], HW, HW, 1)
                    or not torch.isfinite(torch.from_numpy(arr)).all()):
                raise AssertionError(f"MC predict: shape {arr.shape} or non-finite")

    # the raw predictions against the plain model drawing the same masks
    off = Ensemble([_plain_copy(task, model, dev)], monte_carlo_steps=MC_STEPS,
                   generator=torch.Generator(dev).manual_seed(5))
    image = torch.from_numpy(requests[0]).to(dev)
    ens.generator.manual_seed(5)
    got = ens.raw_forward(image)
    want = off.raw_forward(image)
    for name, g, w in zip(("p1", "p2"), got, want):
        if g.shape != (MC_B, S * MC_STEPS, HW, HW, 1):
            raise AssertionError(f"MC {name}: shape {tuple(g.shape)}")
        scale = float(w.abs().max()) or 1.0
        err = float((g - w).abs().max())
        print(f"MC serve {name}: max abs vs ct_kernels=off {err} (scale {scale})")
        if err > 3e-2 * scale:
            raise AssertionError(f"MC {name}: kernel path vs plain {err} > 3e-2 * {scale}")
    ens.generator.manual_seed(6)
    moved = float((ens.raw_forward(image)[0] - got[0]).abs().max())
    print(f"MC serve: another generator moves p1 by {moved}")
    if not moved > 1e-2 * float(got[0].abs().max()):
        raise AssertionError("MC serving: the dropout sites are not live")
    return launches


def _frames(gen, b, hw=NYU):
    """Seeded random uint8 frames and depth labels of size ``hw``."""
    import torch

    return {"image": torch.randint(0, 256, (b, *hw, 3), generator=gen,
                                   dtype=torch.uint8),
            "label": torch.randint(0, 256, (b, *hw, 1), generator=gen,
                                   dtype=torch.uint8)}


def _cos(a, b):
    return float((a * b).sum() / (a.norm() * b.norm() + 1e-12))


def _grad_check(task, state, dev, card, b=TRAIN_B, min_cos=0.99, f32_ref=False,
                hw=NYU):
    """One step's loss and gradients: the kernel path against the plain
    model (ct_kernels="off") with the same weights, inputs and dropout
    masks, on copies of the train state's model: cosine >= ``min_cos`` on
    every leaf above the noise threshold.  ``f32_ref`` also runs the plain
    model in float32: a leaf whose plain bf16 gradient is itself further
    than ``min_cos`` from the f32 one is set by bf16 rounding, not by the
    kernels, and there the kernel path must be as close to the f32
    gradient as the plain model is, up to tests/test_torch_train.py's slack
    (0.15 on the minimum, 0.05 on the mean over those leaves)."""
    import torch
    from mimo_unet_torch.loss_buffer import loss_buffer_init
    from mimo_unet_torch.models.mimo_unet import dropout_sites
    from mimo_unet_torch.ops.dropout import DropoutSource
    from mimo_unet_torch.tasks.evidential import EvidentialUnetTask
    from mimo_unet_torch.tasks.mimo import device_normalize
    from mimo_unet_torch.transforms import apply_input_transform

    batch = device_normalize({k: v.to(dev) for k, v in
                              _frames(torch.Generator().manual_seed(5), b, hw).items()})
    evidential = isinstance(task, EvidentialUnetTask)
    if evidential:  # no input transform: one subnetwork
        image_t, label_t = batch["image"], batch["label"]
    else:
        image_t, label_t, _ = apply_input_transform(
            torch.Generator().manual_seed(6), batch["image"], batch["label"], None, S)
    sites = dropout_sites(task.model_config, image_t.shape[0], *hw)
    source = None
    if sites:  # one draw, given to every run
        drawn = DropoutSource(torch.Generator(dev).manual_seed(8)).draw(sites, dev)
        source = DropoutSource(masks={k: m for k, (m, _) in drawn.items()})
    runs = {"kernels": dict(ct_kernels="auto"), "plain": dict(ct_kernels="off")}
    if f32_ref:
        runs["f32"] = dict(ct_kernels="off", compute_dtype=None)
    results = {}
    for name, kw in runs.items():
        t = dataclasses.replace(task, **kw)
        model = t.build_model(dev)
        model.load_state_dict(state.model.state_dict())
        model.train()
        if evidential:
            loss = t.objective(model, image_t, label_t, None, source)[0]
        else:
            loss = t.objective(model, image_t, label_t, None,
                               loss_buffer_init(S, t.loss_buffer_size, dev), source)[0]
        loss.backward()
        results[name] = (float(loss.detach()), {k: p.grad.float() for k, p in
                                       model.named_parameters() if p.grad is not None})
        del model
    (lk, gk), (lp, gp) = results["kernels"], results["plain"]
    rel = abs(lk - lp) / abs(lp)
    print(f"grad check {hw[0]}x{hw[1]} B={b}: loss kernels {lk} vs plain {lp} "
          f"(rel {rel:.3e}) ({card})")
    if not rel <= 2e-2:
        raise AssertionError(f"train loss: kernel path {lk} vs plain {lp}")
    if gk.keys() != gp.keys():
        raise AssertionError(f"gradient leaves differ: {sorted(gk.keys() ^ gp.keys())}")
    cos = {k: _cos(gk[k], g) for k, g in gp.items()
           if float(g.abs().max()) >= 5e-3}  # else a noise-level leaf
    worst = min(cos, key=cos.get)
    print(f"grad check: {len(cos)} leaves, cosine min {cos[worst]:.5f} ({worst}), "
          f"mean {sum(cos.values()) / len(cos):.5f}")
    noisy = []
    if f32_ref:
        g32 = results["f32"][1]
        print(f"grad check: loss f32 {results['f32'][0]}")
        c_k = {k: _cos(gk[k], g32[k]) for k in cos}
        c_p = {k: _cos(gp[k], g32[k]) for k in cos}
        noisy = [k for k in cos if c_p[k] < min_cos]
        for k in noisy:
            print(f"  bf16-noisy leaf {k}: vs f32 kernels {c_k[k]:.5f}, plain "
                  f"{c_p[k]:.5f}; kernels vs plain {cos[k]:.5f}")
        if noisy:
            mk, mp = min(c_k[k] for k in noisy), min(c_p[k] for k in noisy)
            ak = sum(c_k[k] for k in noisy) / len(noisy)
            ap = sum(c_p[k] for k in noisy) / len(noisy)
            print(f"grad check: {len(noisy)} bf16-noisy leaves, cosine to f32 "
                  f"min kernels {mk:.5f} vs plain {mp:.5f}, mean {ak:.5f} vs {ap:.5f}")
            if mk < mp - 0.15 or ak < ap - 0.05:
                raise AssertionError("kernel path further from the f32 gradients "
                                     "than the plain bf16 model")
    clean = {k: v for k, v in cos.items() if k not in noisy}
    if noisy:
        print(f"grad check: {len(clean)} other leaves, cosine min "
              f"{min(clean.values()):.5f}, mean {sum(clean.values()) / len(clean):.5f}")
    low = {k: v for k, v in clean.items() if v < min_cos}
    if low:
        raise AssertionError(f"gradient cosine < {min_cos}: {low}")
    return cos


def _profile_step(task, state, batch, card, label):
    """Device time of one train step by phase, from torch.profiler's
    kernel events: the port's kernels, the optimizer, everything else."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # K9 and K8's forward are chunk_kernel<g_eff_op / affine_relu_op>, K8's
    # and K12's backward affine_bwd_kernel<0 / OC>
    names = ("conv_fwd_tc", "conv_dx_tc", "conv_dw_tc",
             "g_eff_op", "affine_relu_op", "affine_bwd_kernel<0>", "affine_bwd_kernel",
             "conv1x1", "reduce_groups",
             "pool2x2_kernel", "pool2x2_bwd", "up2_fwd_kernel", "up2_bwd_kernel",
             "upsample_w2x_kernel", "upsample_w2x_bwd_kernel", "lerp_h2x_t_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        task.train_step(state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    phases = {"port kernels": 0.0, "optimizer": 0.0, "other (core, glue)": 0.0}
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        key = ev.key
        ours = [nm for nm in names if nm in key]
        if ours:
            phases["port kernels"] += us
            per_kernel[ours[0]] = per_kernel.get(ours[0], 0.0) + us
        elif "multi_tensor" in key or "adam" in key.lower() or "foreach" in key:
            phases["optimizer"] += us
        else:
            phases["other (core, glue)"] += us
    busy = sum(phases.values()) / 1e3
    print(f"profile {label} step (profiled wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms): " + ", ".join(f"{k} {v / 1e3:.2f} ms"
                                          for k, v in phases.items()) + f" ({card})")
    for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {v / 1e3:.3f} ms")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=60))
    return phases


def _per_step(launches, steps, where):
    """K9 after each of the six convs and K12's backward once: their
    launches over ``steps`` train steps, else raise."""
    want = {"g_eff": 6, "conv1x1_prelu_bwd": 1}
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != steps * v}
    if wrong:
        raise AssertionError(f"{where}: launches {wrong} over {steps} steps "
                             f"(want {want} a step)")


def _time_steps(task, state, gen, b, steps, card, label, hw=NYU):
    import torch

    batches = [_frames(gen, b, hw) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    task.train_step(state, batches[0])  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        task.train_step(state, batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    print(f"train step {hw[0]}x{hw[1]} {label} B={b}: median {med * 1e3:.2f} ms over {steps} "
          f"(min {times[0] * 1e3:.2f}), {b / med:.2f} images/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})",
          flush=True)
    return med


def train(dev, card):
    """Phase 6; returns the train kernels' launch counts over 3 steps."""
    import torch
    from mimo_unet_torch import kernels as K

    task = _train_task()
    spe = -(-795 // TRAIN_B)  # NYUv2's 795 training frames
    state = task.init_state(spe, dev)
    _grad_check(task, state, dev, card)
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(7)
    batches = [_frames(gen, TRAIN_B) for _ in range(3)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for i, batch in enumerate(batches):
        state, logs, _ = task.train_step(state, batch)
        loss = float(logs["train_loss"])
        print(f"train step {i}: loss {loss:.5f}, weights "
              f"{float(logs['train_weight_0']):.4f} {float(logs['train_weight_1']):.4f}")
        if not torch.isfinite(torch.tensor(loss)):
            raise AssertionError(f"step {i}: non-finite loss")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"train launches: {launches}")
    missing = [k.__name__ for k in K.TRAIN_KERNELS + K.RESAMPLE_KERNELS
               if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: {missing}")
    _per_step(launches, 3, "640x480 train")
    bad = [k for k, p in state.model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"non-finite parameters after 3 steps: {bad}")
    if state.step != 3:
        raise AssertionError(f"train state step {state.step}")
    _val_after_train(task, state.model, gen)

    _profile_step(task, state, _frames(gen, TRAIN_B), card, f"640x480 B={TRAIN_B}")
    _time_steps(task, state, gen, TRAIN_B, 5, card, "kernels")
    plain = dataclasses.replace(task, ct_kernels="off")
    pstate = plain.init_state(spe, dev)
    _time_steps(plain, pstate, gen, TRAIN_B, 5, card, "plain (cuDNN bf16)")
    del pstate
    torch.cuda.empty_cache()
    _time_steps(task, state, gen, BIG_B, 3, card, "kernels")
    del state
    torch.cuda.empty_cache()
    pstate = plain.init_state(spe, dev)
    _time_steps(plain, pstate, gen, BIG_B, 3, card, "plain (cuDNN bf16)")
    return launches


def _val_after_train(task, model, gen):
    """``val_step`` on the card model that train steps left in train mode,
    with a CPU batch: a finite loss, no BatchNorm buffer moved, the model
    still in train mode."""
    import math

    import torch

    before = {k: v.clone() for k, v in model.named_buffers()}
    logs, _ = task.val_step(model, _frames(gen, 2))
    loss = float(logs["val_loss"])
    moved = [k for k, v in model.named_buffers() if not torch.equal(v, before[k])]
    print(f"val_step after the train steps (CPU batch, B=2): val_loss {loss:.5f}, "
          f"{len(before)} BatchNorm buffers, {len(moved)} moved, train mode "
          f"{model.training}")
    if not math.isfinite(loss) or moved or not model.training:
        raise AssertionError(f"val_step after train steps: loss {loss}, moved {moved}, "
                             f"train mode {model.training}")


def _train_task(**rates):
    """The NYUv2-depth train task: S=2, fbc=21, bf16, Laplace NLL, lr 1e-3,
    loss buffer 10, with dropout ``rates``."""
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    return MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=S,
                        filter_base_count=F, loss="laplace_nll",
                        learning_rate=1e-3, loss_buffer_size=10,
                        compute_dtype="bfloat16", **rates)


def train_patch(dev, card):
    """Phase 11: the flagship step at 256x256 patches; returns the launch
    counts over 3 B=64 steps."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.fast_path import train_path_supported

    task = _train_task()
    if not train_path_supported(task.model_config, (BIG_B, S, *PATCH, 3), dev,
                                training=True):
        raise AssertionError("256x256 does not take the train kernel route")
    spe = -(-795 // BIG_B)
    state = task.init_state(spe, dev)
    _grad_check(task, state, dev, card, f32_ref=True, hw=PATCH)
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(10)
    batches = [_frames(gen, BIG_B, PATCH) for _ in range(3)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for i, batch in enumerate(batches):
        state, logs, _ = task.train_step(state, batch)
        loss = float(logs["train_loss"])
        print(f"256x256 train step {i} B={BIG_B}: loss {loss:.5f}")
        if not torch.isfinite(torch.tensor(loss)):
            raise AssertionError(f"256x256 step {i}: non-finite loss")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"256x256 train launches: {launches}")
    missing = [k.__name__ for k in K.TRAIN_KERNELS if launches[k.__name__] <= 0]
    # per step: two pools (in_conv -> down1, down1 -> core), one upsample
    per_step = {"max_pool2x2": 2, "max_pool2x2_bwd": 2, "upsample2x": 1,
                "upsample2x_bwd": 1}
    wrong = {k: launches[k] for k, v in per_step.items() if launches[k] != 3 * v}
    if missing or wrong:
        raise AssertionError(f"256x256 train launches: missing {missing}, "
                             f"K10/K13 counts {wrong} (want {per_step} per step)")
    _per_step(launches, 3, "256x256 train")
    if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after 3 256x256 steps")

    _profile_step(task, state, _frames(gen, BIG_B, PATCH), card, f"256x256 B={BIG_B}")
    plain = dataclasses.replace(task, ct_kernels="off")
    for b, steps in ((TRAIN_B, 5), (BIG_B, 3)):
        _time_steps(task, state, gen, b, steps, card, "kernels", PATCH)
        pstate = plain.init_state(spe, dev)
        _time_steps(plain, pstate, gen, b, steps, card, "plain (cuDNN bf16)", PATCH)
        del pstate
        torch.cuda.empty_cache()
    return launches


def train_tail(dev, card):
    """Phase 12: the tail sites against their plain versions, then one
    48x48 B=3 step of the fbc-40 task on the kernel route."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.fast_path import train_path_supported

    for st in tail_sites(dev, torch.Generator(device=dev).manual_seed(4)):
        got = st.kern()
        err = compare(f"{st.name} [{st.site}]", got, st.plain(), st.exact)
        rpt = ""
        if st.name in TC_KERNELS + REDESIGNED:
            compare(f"{st.name} [{st.site}] launch to launch", st.kern(), got, True)
            rpt = ", launch to launch bitwise"
        print(f"tail {st.name} [{st.site}]: max_abs_err {err} ({_mode(st.exact)}{rpt})")
    task = dataclasses.replace(_train_task(), filter_base_count=40)
    b, hw = 3, (48, 48)
    if not train_path_supported(task.model_config, (b, S, *hw, 3), dev,
                                training=True):
        raise AssertionError("48x48 fbc 40 does not take the train kernel route")
    state = task.init_state(1, dev)
    K.reset_launch_counts()
    _grad_check(task, state, dev, card, b=b, f32_ref=True, hw=hw)
    launches = K.launch_counts()
    missing = [k.__name__ for k in K.TRAIN_KERNELS + K.RESAMPLE_KERNELS
               if launches[k.__name__] <= 0]
    print(f"48x48 fbc 40 B={b} step launches: {launches}")
    if missing:
        raise AssertionError(f"kernels not launched at 48x48 fbc 40: {missing}")


def x2_half_sites(dev, gen):
    """K4b and K14 at the x2-half decoder's up4 sites (models/fast_path.py
    ``mimo_unet_apply_train`` with the flag): the cotangent of the W-half
    upsampled core output [B, H/2, W, C_up] and of its full-res rows
    [B, H, W, C_up], at 256x256 B=64 and 640x480 B=4.  Library: the
    autograd backward of ``F.interpolate`` (bilinear, align_corners) to
    the same size on the channels-last tensor: (H/2, W) from W/2 columns
    for K4b, (H, W) from H/2 rows for K14."""
    import torch
    import torch.nn.functional as Fn
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    c = F * S  # the core's output channels

    def act(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(bf)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def interp_backward(x, g):
        xl = nchw(x).detach().requires_grad_()
        out = Fn.interpolate(xl, size=tuple(g.shape[1:3]), mode="bilinear",
                             align_corners=True)
        gl = nchw(g)
        return lambda: torch.autograd.grad(out, xl, gl, retain_graph=True)

    sites = []
    for b, (h, w) in ((BIG_B, PATCH), (TB, NYU)):
        tag = f"{h}x{w} B={b}"
        gh, gw = act(b, h // 2, w, c), act(b, h, w, c)
        half = _nbytes((gh.shape, 2))
        sites.append(Site(
            "upsample_w2x_bwd", f"up4 W-half cotangent {tag} [{b},{h // 2},{w},{c}]",
            lambda gh=gh: K.upsample_w2x_bwd(gh), lambda gh=gh: K.upsample_w2x_bwd_plain(gh),
            True, 5.0 * gh.numel(), 1.5 * half,
            interp_backward(act(b, h // 2, w // 2, c), gh)))
        sites.append(Site(
            "lerp_h2x_transpose", f"up4 H-lerp cotangent {tag} [{b},{h},{w},{c}]",
            lambda gw=gw: K.lerp_h2x_transpose(gw),
            lambda gw=gw: K.lerp_h2x_transpose_plain(gw),
            True, 5.0 * gw.numel(), 3.0 * half,
            interp_backward(act(b, h // 2, w, c), gw)))
    return sites


def x2_half_conv_sites(dev, gen):
    """K5 and K7 with ``x2_half_h`` at dec.c1 (640x480 B=4): against
    their plain versions (phase 3's tolerance), and returns the bitwise
    checks against the full-res form fed K13's output; K4 at the
    x2-half decoder's 256x256 B=64 site."""
    import torch
    from mimo_unet_torch import kernels as K

    bf = torch.bfloat16
    n, c_up = S * TB, F * S
    mid = (F + c_up) // 2

    def act(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(bf)

    x1s = act(n, TH, TW, F)
    xh = act(TB, TH // 2, TW // 2, c_up)
    half, full = K.upsample_w2x(xh), K.upsample2x(xh)
    w = ((torch.rand((S, 3, 3, F + c_up, mid), device=dev, generator=gen) * 2 - 1)
         / (9 * (F + c_up)) ** 0.5).to(bf).float()
    g = act(n, TH, TW, mid, scale=0.01)
    px = n * TH * TW
    flops = 2.0 * px * 9 * (F + c_up) * mid
    in_bytes = _nbytes((x1s.shape, 2), (half.shape, 2))
    y_bytes = _nbytes(((n, TH, TW, mid), 2))
    w_bytes = _nbytes((w.shape, 2))
    label = f"decoder conv1 (21+42)->31 x2_half_h @{TW}x{TH} B={TB}"
    sites = [
        Site("conv3x3_fwd", label,
             lambda: K.conv3x3_fwd(x1s, w, x2=half, x2_half_h=True),
             lambda: K.conv3x3_fwd_plain(x1s, w, x2=half, x2_half_h=True),
             False, flops, in_bytes + w_bytes + y_bytes, before=10.547, repeat=True),
        Site("conv3x3_dw", label,
             lambda: K.conv3x3_dw(g, x1s, S, x2=half, x2_half_h=True),
             lambda: K.conv3x3_dw_plain(g, x1s, S, x2=half, x2_half_h=True),
             False, flops, in_bytes + y_bytes + _nbytes((w.shape, 4)),
             before=17.009, repeat=True),
    ]
    # K4 at the x2-half decoder's 256x256 B=64 site: the core output's W
    # half; library F.interpolate of the W axis alone (align_corners) on
    # the channels-last tensor
    xc = act(BIG_B, HW // 2, HW // 2, c_up)
    sites.append(Site(
        "upsample_w2x", f"x2-half up4 W-half 256x256 B={BIG_B} {list(xc.shape)}",
        lambda: K.upsample_w2x(xc), lambda: K.upsample_w2x_plain(xc), True,
        3.0 * xc.numel() * 2, _nbytes((xc.shape, 2)) * 3,
        lambda: torch.nn.functional.interpolate(
            xc.permute(0, 3, 1, 2), size=(HW // 2, HW), mode="bilinear",
            align_corners=True)))
    same = [("conv3x3_fwd", lambda: K.conv3x3_fwd(x1s, w, x2=half, x2_half_h=True),
             lambda: K.conv3x3_fwd(x1s, w, x2=full)),
            ("conv3x3_dw", lambda: K.conv3x3_dw(g, x1s, S, x2=half, x2_half_h=True),
             lambda: K.conv3x3_dw(g, x1s, S, x2=full))]
    return sites, same


def _objective_run(task, state, dev, image_t, label_t):
    """One forward + backward of the train objective on a copy of the
    state's model: (logits, loss, gradients, running statistics, the
    cotangent of the shared core's output)."""
    import torch
    from mimo_unet_torch.loss_buffer import loss_buffer_init

    model = task.build_model(dev)
    model.load_state_dict(state.model.state_dict())
    model.train()
    core_ct = []

    def keep_cotangent(mod, args, out):
        out.register_hook(lambda g: core_ct.append(g.clone()))

    hook = model.core.register_forward_hook(keep_cotangent)
    loss, _, _, p1, p2 = task.objective(model, image_t, label_t, None,
                                        loss_buffer_init(S, task.loss_buffer_size, dev))
    loss.backward()
    hook.remove()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (torch.cat([p1, p2], dim=-1).detach(), loss.detach(), grads, stats,
            core_ct[0])


def _x2_half_bitwise(task, state, dev, card):
    """One B=16 256x256 step's forward and backward, flag on against flag
    off (twice), on the same weights and inputs: the logits, the loss, the
    running statistics, the core output's cotangent and the decoder's
    gradients bitwise; every other gradient bitwise or no further from
    the flag-off one than the second flag-off run is."""
    import torch
    from mimo_unet_torch.tasks.mimo import device_normalize
    from mimo_unet_torch.transforms import apply_input_transform

    batch = device_normalize({k: v.to(dev) for k, v in _frames(
        torch.Generator().manual_seed(11), TRAIN_B, PATCH).items()})
    image_t, label_t, _ = apply_input_transform(
        torch.Generator().manual_seed(12), batch["image"], batch["label"], None, S)
    runs = {}
    for name, flag in (("off", "0"), ("on", "1"), ("off again", "0")):
        os.environ[X2_HALF] = flag
        runs[name] = _objective_run(task, state, dev, image_t, label_t)
    os.environ[X2_HALF] = "0"
    (lo, loss_off, g_off, st_off, ct_off), (lh, loss_on, g_on, st_on, ct_on) = (
        runs["off"], runs["on"])
    g_off2 = runs["off again"][2]
    if not torch.equal(ct_on, ct_off):
        raise AssertionError(f"x2-half: the core output's cotangent differs, max abs "
                             f"{float((ct_on - ct_off).abs().max())}")
    if not (torch.equal(lh, lo) and torch.equal(loss_on, loss_off)):
        raise AssertionError(f"x2-half logits or loss differ: max abs "
                             f"{float((lh - lo).abs().max())}, loss {float(loss_on)} vs "
                             f"{float(loss_off)}")
    bad = [k for k in st_off if not torch.equal(st_on[k], st_off[k])]
    if bad:
        raise AssertionError(f"x2-half running statistics differ: {bad}")
    if g_on.keys() != g_off.keys():
        raise AssertionError("x2-half gradient leaves differ")
    same, spread, far = [], [], []
    for k in g_off:
        if torch.equal(g_on[k], g_off[k]):
            same.append(k)
            continue
        if k.startswith("decoder."):
            far.append(k)
            continue
        d_on = float((g_on[k] - g_off[k]).abs().max())
        d_off = float((g_off2[k] - g_off[k]).abs().max())
        spread.append(f"{k} {d_on:.3e} (off runs {d_off:.3e})")
        if d_on > d_off:
            far.append(k)
    print(f"x2-half step 256x256 B={TRAIN_B}: logits, loss {float(loss_on)}, running "
          f"statistics bitwise; {len(same)} of {len(g_off)} gradient leaves bitwise "
          f"({card})")
    for line in spread:
        print(f"  not bitwise: {line}")
    if far:
        raise AssertionError(f"x2-half gradients further from flag-off than the "
                             f"flag-off runs' spread (or a decoder leaf): {far}")


def train_x2_half(dev, card):
    """Phase 13's steps; returns the launch counts of the 256x256 B=64
    steps."""
    import torch
    from mimo_unet_torch import kernels as K

    task = _train_task()
    per_step = {"upsample_w2x": 1, "upsample_w2x_bwd": 1, "lerp_h2x_transpose": 1,
                "upsample2x": 0, "upsample2x_bwd": 0, "max_pool2x2": 2,
                "max_pool2x2_bwd": 2}
    gen = torch.Generator().manual_seed(13)
    states, counts = {}, {}
    os.environ[X2_HALF] = "1"
    for b, hw in ((BIG_B, PATCH), (TRAIN_B, NYU)):
        state = task.init_state(-(-795 // b), dev)
        batches = [_frames(gen, b, hw) for _ in range(3)]
        torch.cuda.synchronize()
        K.reset_launch_counts()
        for batch in batches:
            state, logs, _ = task.train_step(state, batch)
            if not torch.isfinite(logs["train_loss"]):
                raise AssertionError(f"x2-half {hw} step: non-finite loss")
        torch.cuda.synchronize()
        launches = K.launch_counts()
        print(f"x2-half {hw[0]}x{hw[1]} B={b} 3 steps: launches {launches}")
        missing = [k.__name__ for k in K.TRAIN_KERNELS if launches[k.__name__] <= 0]
        wrong = {k: launches[k] for k, v in per_step.items() if launches[k] != 3 * v}
        if missing or wrong:
            raise AssertionError(f"x2-half {hw} launches: missing {missing}, counts "
                                 f"{wrong} (want {per_step} per step)")
        if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
            raise AssertionError(f"non-finite parameters after 3 x2-half {hw} steps")
        states[hw], counts[hw] = state, launches
    # deterministic algorithms for the comparison: the plain core's
    # backward (cuDNN, atomics) otherwise differs from run to run
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _x2_half_bitwise(task, states[PATCH], dev, card)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    os.environ[X2_HALF] = "1"
    _profile_step(task, states[PATCH], _frames(gen, BIG_B, PATCH), card,
                  f"x2-half 256x256 B={BIG_B}")
    for b, hw in ((BIG_B, PATCH), (TRAIN_B, NYU)):
        for flag in ("1", "0", "0", "1"):
            os.environ[X2_HALF] = flag
            _time_steps(task, states[hw], gen, b, 3, card,
                        f"x2-half {'on' if flag == '1' else 'off'}", hw)
        torch.cuda.empty_cache()
    os.environ[X2_HALF] = "0"
    return counts[PATCH]


# ---- phase 14: the train harness and the remat rungs -----------------------

# a train step's launches on the default route (phase 11's counts and the
# rest) and an eval forward's; what each remat rung launches again in the
# backward, on the default route and on the final-dropout route
STEP_LAUNCHES = {"conv3x3_fwd": 6, "conv3x3_dx": 4, "conv3x3_dx_fold": 1, "conv3x3_dw": 6,
                 "g_eff": 6, "affine_relu": 2, "affine_relu_bwd": 2, "conv1x1_prelu": 1,
                 "conv1x1_prelu_bwd": 1, "max_pool2x2": 2, "max_pool2x2_bwd": 2,
                 "upsample2x": 1, "upsample2x_bwd": 1}
EVAL_LAUNCHES = {"fused_double_conv9": 1, "fused_double_conv": 3, "pool_w": 2,
                 "upsample_w2x": 2}
_ENC_AGAIN = {"conv3x3_fwd": 4, "affine_relu": 2, "max_pool2x2": 2}
REMAT_AGAIN = {
    "default": {"none": {}, "enc": _ENC_AGAIN,
                "all": {"conv3x3_fwd": 6, "affine_relu": 2, "max_pool2x2": 2,
                        "upsample2x": 1, "conv1x1_prelu": 1}},
    "final-dropout": {"none": {}, "enc": _ENC_AGAIN,
                      "all": {"conv3x3_fwd": 6, "affine_relu": 3, "max_pool2x2": 2,
                              "upsample2x": 1, "conv1x1": 1}},
}
HARNESS_TRAIN, HARNESS_VAL = 256, 64   # synthetic frames of the fit phase


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms (the plain core's cuDNN backward otherwise
    differs from run to run), then back to the defaults."""
    import torch

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def _nyu_arrays(n, seed, hw=PATCH):
    """``n`` seeded frames in NYUv2's uint8 schema
    (mimo_unet_tpu/data/nyuv2.py:5-7, 73-77): image [n, H, W, 3], depth
    label [n, H, W, 1]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8),
            "label": rng.integers(0, 256, (n, *hw, 1), dtype=np.uint8)}


def _harness_data():
    """A DataModule of HARNESS_TRAIN train and HARNESS_VAL val frames at
    256x256, batch BIG_B."""
    from mimo_unet_torch.data.core import ArrayDataset, DataModule

    class Frames(DataModule):
        batch_size = BIG_B

        def __init__(self):
            self.train = ArrayDataset(_nyu_arrays(HARNESS_TRAIN, 20))
            self.val = ArrayDataset(_nyu_arrays(HARNESS_VAL, 21))

        def setup(self):
            pass

        def train_dataset(self):
            return self.train

        def val_dataset(self):
            return self.val

    return Frames()


def _state_bits(state, grads=False):
    """Every tensor a train step writes in ``state`` by name: the model's
    state dict, Adam's moments, the loss buffer, both generators, and step,
    ring index, schedule position and learning rate; ``grads`` the
    gradients too."""
    import torch

    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    names = {id(p): k for k, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"adam.{names[id(p)]}.{k}"] = v
    if grads:
        out.update({f"grad.{k}": p.grad for k, p in state.model.named_parameters()})
    out["loss_buffer"] = state.loss_buffer.buffer
    out["generator"] = state.generator.get_state()
    out["dropout_generator"] = state.dropout_generator.get_state()
    out["numbers"] = torch.tensor([state.step, state.loss_buffer.index,
                                   state.scheduler.last_epoch,
                                   state.optimizer.param_groups[0]["lr"]],
                                  dtype=torch.float64)
    return out


def _same_state(a, b, what, grads=False):
    import torch

    ta, tb = _state_bits(a, grads), _state_bits(b, grads)
    bad = sorted(k for k in ta.keys() | tb.keys()
                 if k not in ta or k not in tb or not torch.equal(ta[k], tb[k]))
    print(f"{what}: {len(ta)} state tensors, {len(bad)} differ")
    if bad:
        raise AssertionError(f"{what}: not bitwise: {bad[:10]}")


def _want_launches(got, want, where):
    """Launch counts ``got`` against ``want`` (every other kernel 0)."""
    wrong = {k: (v, want.get(k, 0)) for k, v in got.items() if v != want.get(k, 0)}
    if wrong:
        raise AssertionError(f"{where}: launches (got, want) {wrong}")
    return got


def _launches_since(want, where):
    """The launch counters against ``want`` (every other kernel 0)."""
    import torch
    from mimo_unet_torch import kernels as K

    torch.cuda.synchronize()
    return _want_launches(K.launch_counts(), want, where)


def _fit(dev, card, root):
    """Trainer.fit for 2 epochs: every train kernel in each step and the
    eval kernels in validation, finite losses, last/ and best/ written."""
    import math

    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.train.trainer import Trainer

    task = _train_task()
    dm = _harness_data()
    steps = 2 * (HARNESS_TRAIN // BIG_B)
    path = os.path.join(root, "fit")
    # every other step takes the with_outputs route; without matplotlib the
    # trainer reports that it cannot draw the image grids and goes on
    trainer = Trainer(task, dm, max_epochs=2, checkpoint_path=path, log_every_n_steps=2,
                      device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.fit()
    wall = time.perf_counter() - t0
    want = {k: steps * v for k, v in STEP_LAUNCHES.items()}
    want.update({k: 2 * v for k, v in EVAL_LAUNCHES.items()})  # one val batch an epoch
    launches = _launches_since(want, "Trainer.fit")
    with open(os.path.join(path, "metrics.tsv")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    vals = [h["val_loss"] for h in trainer.history]
    print(f"Trainer.fit 2 epochs, {steps} steps {PATCH[0]}x{PATCH[1]} B={BIG_B}: {wall:.2f} s, train "
          f"losses {losses}, val losses {vals}, launches {launches} ({card})")
    if not (losses and all(map(math.isfinite, losses + vals)) and state.step == steps):
        raise AssertionError(f"Trainer.fit: losses {losses}, val {vals}, step {state.step}")
    for d in ("last", "best"):
        for f in ("hparams.json", os.path.join("state", "state.pt")):
            if not os.path.isfile(os.path.join(path, d, f)):
                raise AssertionError(f"Trainer.fit wrote no {d}/{f}")
    return dm


def _resume_bitwise(dev, dm, root):
    """Under deterministic algorithms: 1 epoch, then a resume to 3, is
    bitwise 3 straight epochs."""
    from mimo_unet_torch.train.trainer import Trainer

    task = _train_task()

    def fit(name, epochs, resume=False):
        return Trainer(task, dm, max_epochs=epochs, checkpoint_path=os.path.join(root, name),
                       log_every_n_steps=4, log_images=False, device=dev).fit(resume=resume)

    with _deterministic():
        straight = fit("straight", 3)
        fit("resumed", 1)
        resumed = fit("resumed", 3, resume=True)
    _same_state(resumed, straight, "1 epoch + resume to 3 vs 3 straight epochs")


def _harness_overhead(dev, dm, card, root):
    """Images/s of Trainer.fit (epochs 1-2 of 3) against a bare train_step
    loop over the same host-fed batches, in turns."""
    import torch
    from mimo_unet_torch.train.trainer import Trainer

    task = _train_task()
    spe = HARNESS_TRAIN // BIG_B

    def fit(turn):
        t = Trainer(task, dm, max_epochs=3, checkpoint_path=os.path.join(root, f"rate{turn}"),
                    log_every_n_steps=50, log_images=False, device=dev)
        t.fit()
        return [h["throughput_images_per_sec"] for h in t.history[1:]]

    def bare(_):
        state = task.init_state(spe, dev)
        rates = []
        for epoch in range(3):
            t0 = time.perf_counter()
            n = 0
            for batch in dm.train_batches(epoch, seed=42):
                state, _, _ = task.train_step(
                    state, {k: torch.from_numpy(v) for k, v in batch.items()})
                n += len(batch["image"])
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
        return rates[1:]

    runs = {"fit": [], "bare": []}
    for turn, name in enumerate(("fit", "bare", "bare", "fit")):
        runs[name] += (fit if name == "fit" else bare)(turn)
    mean = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"harness overhead {PATCH[0]}x{PATCH[1]} B={BIG_B}: Trainer.fit {runs['fit']} images/s (mean "
          f"{mean['fit']:.2f}), bare train_step loop {runs['bare']} (mean {mean['bare']:.2f}); "
          f"fit/bare {mean['fit'] / mean['bare']:.4f} ({card})", flush=True)


def _rung_bitwise(task, dev, b, hw, route, card):
    """One forward + backward per remat rung from the same weights, inputs
    and masks, under deterministic algorithms: loss, gradients and running
    statistics bitwise those of "none", num_batches_tracked 1 in every
    BatchNorm, and each rung's launches those of "none" plus what it
    recomputes (REMAT_AGAIN)."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.loss_buffer import loss_buffer_init
    from mimo_unet_torch.models.mimo_unet import dropout_sites
    from mimo_unet_torch.ops.dropout import DropoutSource
    from mimo_unet_torch.tasks.mimo import device_normalize
    from mimo_unet_torch.train.capacity import RUNGS
    from mimo_unet_torch.transforms import apply_input_transform

    state = task.init_state(1, dev)
    batch = device_normalize({k: v.to(dev) for k, v in _frames(
        torch.Generator().manual_seed(31), b, hw).items()})
    image_t, label_t, _ = apply_input_transform(
        torch.Generator().manual_seed(32), batch["image"], batch["label"], None, S)
    sites = dropout_sites(task.model_config, b, *hw)
    source = None
    if sites:
        drawn = DropoutSource(torch.Generator(dev).manual_seed(33)).draw(sites, dev)
        source = DropoutSource(masks={k: m for k, (m, _) in drawn.items()})
    runs = {}
    with _deterministic():
        for rung in RUNGS:
            t = dataclasses.replace(task, remat=rung)
            model = t.build_model(dev)
            model.load_state_dict(state.model.state_dict())
            model.train()
            torch.cuda.synchronize()
            K.reset_launch_counts()
            loss = t.objective(model, image_t, label_t, None,
                               loss_buffer_init(S, t.loss_buffer_size, dev), source)[0]
            loss.backward()
            torch.cuda.synchronize()
            runs[rung] = (loss.detach(), K.launch_counts(),
                          {k: p.grad for k, p in model.named_parameters() if p.grad is not None},
                          {k: v for k, v in model.state_dict().items()
                           if k.endswith(("running_mean", "running_var",
                                          "num_batches_tracked"))})
            del model, loss
    loss0, launch0, g0, st0 = runs["none"]
    tracked = {int(v) for k, v in st0.items() if k.endswith("num_batches_tracked")}
    if tracked != {1}:
        raise AssertionError(f"remat {route}: num_batches_tracked {tracked} after one step")
    for rung in RUNGS[1:]:
        loss, launches, g, st = runs[rung]
        bad = [k for k in g0 if k not in g or not torch.equal(g[k], g0[k])]
        bad += [k for k in st0 if not torch.equal(st[k], st0[k])]
        if not torch.equal(loss, loss0) or bad or g.keys() != g0.keys():
            raise AssertionError(f"remat={rung} {route} {hw} B={b}: loss {float(loss)} vs "
                                 f"{float(loss0)}, not bitwise: {bad[:10]}")
        again = {k: launches[k] - launch0[k] for k in launches if launches[k] != launch0[k]}
        if again != REMAT_AGAIN[route][rung]:
            raise AssertionError(f"remat={rung} {route}: launches again {again}, want "
                                 f"{REMAT_AGAIN[route][rung]}")
        print(f"remat={rung} {route} {hw[0]}x{hw[1]} B={b}: loss, {len(g0)} gradients and "
              f"{len(st0)} BatchNorm buffers bitwise remat='none'; launched again {again} "
              f"({card})")
    print(f"remat='none' {route} {hw[0]}x{hw[1]} B={b} launches: {launch0}")


def _rung_times(task, dev, b, hw, card):
    """Step time and peak memory per rung, in turns (none, enc, all, all,
    enc, none) on one state; returns {rung: peak bytes}."""
    import dataclasses as dc

    import torch
    from mimo_unet_torch.train.capacity import RUNGS

    state = task.init_state(-(-795 // b), dev)
    gen = torch.Generator().manual_seed(34)
    times, peaks = {r: [] for r in RUNGS}, {r: 0 for r in RUNGS}
    for rung in RUNGS + RUNGS[::-1]:
        state.model.config = dc.replace(state.model.config, remat=rung)
        torch.cuda.empty_cache()
        times[rung].append(_time_steps(task, state, gen, b, 3, card, f"remat={rung}", hw))
        peaks[rung] = max(peaks[rung], torch.cuda.max_memory_allocated())
    print(f"remat {hw[0]}x{hw[1]} B={b}: " + "; ".join(
        f"{r} step {sum(times[r]) / 2 * 1e3:.2f} ms (turns {[round(t * 1e3, 2) for t in times[r]]}), "
        f"peak {peaks[r] / 2 ** 30:.3f} GiB" for r in RUNGS) + f" ({card})", flush=True)
    del state
    torch.cuda.empty_cache()
    return peaks


def _ladder(task, dev, card):
    """make_train_step under a memory cap between the "none" and "enc"
    steps' peaks (measured here, deterministic algorithms, as the ladder
    then runs): it must pick "enc", and its step be bitwise a direct "enc"
    step from the same state.  The cap is lifted after."""
    import dataclasses as dc

    import torch
    from mimo_unet_torch.train.capacity import make_train_step

    batch = _frames(torch.Generator().manual_seed(35), BIG_B, PATCH)
    spe = -(-795 // BIG_B)
    enc_task = dc.replace(task, remat="enc")
    with _deterministic():
        probe = task.init_state(spe, dev)
        peaks = {}
        for rung in ("none", "enc"):
            probe.model.config = dc.replace(probe.model.config, remat=rung)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            task.train_step(probe, batch)
            torch.cuda.synchronize()
            peaks[rung] = torch.cuda.max_memory_allocated()
        del probe
        a, direct = task.init_state(spe, dev), enc_task.init_state(spe, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        cap = (peaks["none"] + peaks["enc"]) / 2
        total = torch.cuda.get_device_properties(dev).total_memory
        torch.cuda.set_per_process_memory_fraction(cap / total, dev)
        try:
            _, used = make_train_step(task, a, batch)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
        enc_task.train_step(direct, batch)
    print(f"ladder {PATCH[0]}x{PATCH[1]} B={BIG_B}: peaks none {peaks['none'] / 2 ** 30:.3f} GiB, enc "
          f"{peaks['enc'] / 2 ** 30:.3f} GiB, cap {cap / 2 ** 30:.3f} GiB: make_train_step "
          f"chose remat={used.remat!r} ({card})")
    if used.remat != "enc":
        raise AssertionError(f"the ladder chose {used.remat!r} under the cap, not 'enc'")
    _same_state(a, direct, "ladder step under the cap vs a direct remat='enc' step",
                grads=True)


def train_harness(dev, card):
    """Phase 14: the train harness and the remat rungs."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)  # git-ignored, not checked out
    root = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(REPO, "build"))
    try:
        dm = _fit(dev, card, root)
        _resume_bitwise(dev, dm, root)
        _harness_overhead(dev, dm, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del dm
    torch.cuda.empty_cache()
    task = _train_task()
    _rung_bitwise(task, dev, BIG_B, PATCH, "default", card)
    _rung_bitwise(dataclasses.replace(task, final_dropout_rate=0.1), dev, TB, NYU,
                  "final-dropout", card)
    torch.cuda.empty_cache()
    _rung_times(task, dev, BIG_B, PATCH, card)
    _rung_times(task, dev, BIG_B, NYU, card)
    _ladder(task, dev, card)
    torch.cuda.empty_cache()
    print(f"phase 14 (train harness, remat): {time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def record_groups(names):
    """Record the groups argument (the last before the stream) of every
    launch of the library entries ``names``: {name: set of groups}."""
    from mimo_unet_torch.kernels import _build

    seen = {n: set() for n in names}
    launch = _build.launch

    def recording(name, device, *args):
        if name in seen:
            seen[name].add(int(args[-1]))
        return launch(name, device, *args)

    _build.launch = recording
    try:
        yield seen
    finally:
        _build.launch = launch


def train_mc(dev, card):
    """Phase 9; returns the launch counts of the MC-recipe steps and of the
    final-dropout step."""
    import torch
    from mimo_unet_torch import kernels as K

    task = _train_task(**MC_RECIPE)
    spe = -(-795 // TRAIN_B)
    state = task.init_state(spe, dev)
    _grad_check(task, state, dev, card, min_cos=0.999, f32_ref=True)
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(9)
    batches = [_frames(gen, TRAIN_B) for _ in range(3)]
    per_image = ("mimo_affine_relu", "mimo_affine_relu_bwd", "mimo_conv1x1_prelu",
                 "mimo_conv1x1_prelu_bwd")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with record_groups(per_image) as groups:
        for i, batch in enumerate(batches):
            state, logs, _ = task.train_step(state, batch)
            loss = float(logs["train_loss"])
            print(f"MC-recipe train step {i}: loss {loss:.5f}")
            if not torch.isfinite(torch.tensor(loss)):
                raise AssertionError(f"MC step {i}: non-finite loss")
        torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"MC-recipe train launches: {launches}; K8/K12 groups: {groups}")
    missing = [k.__name__ for k in K.TRAIN_KERNELS + K.RESAMPLE_KERNELS
               if launches[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the MC train path: {missing}")
    _per_step(launches, 3, "MC-recipe train")
    not_per_image = [k for k, g in groups.items() if S * TRAIN_B not in g]
    if not_per_image:
        raise AssertionError(f"no launch at groups = N: {not_per_image}")
    if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after 3 MC-recipe steps")
    _time_steps(task, state, gen, TRAIN_B, 5, card, "MC recipe, kernels")
    del state
    plain = dataclasses.replace(task, ct_kernels="off")
    pstate = plain.init_state(spe, dev)
    _time_steps(plain, pstate, gen, TRAIN_B, 5, card, "MC recipe, plain (cuDNN bf16)")
    del pstate
    torch.cuda.empty_cache()

    # the final-dropout route: K8, the elementwise dropout, K11 fwd + bwd
    ftask = dataclasses.replace(task, final_dropout_rate=0.1,
                                **{k: 0.0 for k in MC_RECIPE})
    fstate = ftask.init_state(spe, dev)
    batch = _frames(gen, TB)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    fstate, logs, _ = ftask.train_step(fstate, batch)
    torch.cuda.synchronize()
    flaunch = K.launch_counts()
    print(f"final-dropout step B={TB}: loss {float(logs['train_loss']):.5f}, "
          f"launches {flaunch}")
    missing = [k.__name__ for k in (K.conv1x1, K.conv1x1_bwd, K.affine_relu,
                                    K.affine_relu_bwd) if flaunch[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the final-dropout route: {missing}")
    _grad_check(ftask, fstate, dev, card, b=TB, min_cos=0.999, f32_ref=True)
    return launches, flaunch


# ---- phase 15: the evidential task and the offline evaluation -------------

EV_F, EV_OC = 32, 4          # the evidential U-Net: S=1, fbc 32 (the CLI default), 4 outputs
EV_TAG = "evidential "       # the label prefix of its kernel sites
EV_PRED_N, EV_EPS = 64, 0.01  # frames of the offline evaluation; its FGSM epsilon


def _beside_flagship(ev_sites, flag_sites, card, tag=EV_TAG):
    """Each site's device time (its label prefixed with ``tag``: the
    evidential's, or another configuration's) beside the flagship's at the
    same call site (the lists pair by position)."""
    for ev, fl in zip(ev_sites, flag_sites, strict=True):
        if ev.name != fl[0]:
            raise AssertionError(f"site lists out of step: {ev.name} vs {fl[0]}")
        print(f"{tag}{ev.name} [{ev.site[len(tag):]}] {SITE_MS[(ev.name, ev.site)]:.4f} "
              f"ms vs flagship [{fl[1]}] {SITE_MS[fl]:.4f} ms ({card})")


def _ev_frames(n, seed):
    """``n`` float NYUv2-schema frames at 256x256 in [0, 1] (as the
    evaluation scripts load them, normalized), as a dataset."""
    from mimo_unet_torch.data.core import ArrayDataset

    arrays = _nyu_arrays(n, seed)
    return ArrayDataset({k: (v / 255.0).astype("float32") for k, v in arrays.items()})


def _check_attack(clean, attacked, grad, eps, where):
    """The FGSM inputs: in [0, 1]; where the gradient stands clear of
    rounding (|g| > 1e-6 max|g|) exactly clip(x + eps sign(g)), so moved
    unless clipped at the edge it points past."""
    import torch

    x, xa = torch.from_numpy(clean), torch.from_numpy(attacked)
    if not (float(xa.min()) >= 0.0 and float(xa.max()) <= 1.0):
        raise AssertionError(f"{where}: perturbed inputs outside [0, 1]")
    strong = grad.abs() > 1e-6 * float(grad.abs().max())
    want = torch.clamp(x + eps * torch.sign(grad), 0.0, 1.0)
    edge = ((x == 0) & (grad < 0)) | ((x == 1) & (grad > 0))
    moved = xa != x
    if not torch.equal(xa[strong], want[strong]) or bool((strong & ~edge & ~moved).any()):
        raise AssertionError(f"{where}: perturbed inputs are not FGSM's")
    print(f"{where}: {float(moved.float().mean()):.4f} of the input moved, "
          f"{float(strong.float().mean()):.4f} strong-gradient pixels all FGSM's")


def _hold_predictions(got, want, where):
    """(y_pred, aleatoric, epistemic) of the kernel route against the plain
    model's at phase 3's tolerance; the inputs bitwise (both gradients run
    the plain modules)."""
    import numpy as np
    import torch

    if not np.array_equal(got[0], want[0]):
        raise AssertionError(f"{where}: the perturbed inputs differ from the plain model's")
    errs = [compare(f"{where} {name}", torch.from_numpy(g), torch.from_numpy(w), False)
            for name, g, w in zip(("y_pred", "aleatoric", "epistemic"), got[1:4], want[1:4])]
    print(f"{where}: predictions vs the plain model, max abs {errs}")


def _timed_call(fn, batches, where, card):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"{where}: {(time.perf_counter() - t0) * 1e3 / batches:.2f} ms per batch of "
          f"{EV_PRED_N // batches} ({card})", flush=True)
    return out


def _ev_eval(task, model, card, dev):
    """make_predictions_evidential at eps 0 and EV_EPS: eval kernels once
    per batch's final forward and nothing else, the FGSM inputs, the NLL
    raised, predictions against the plain model.  Returns the eps-0
    launches."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.eval import make_predictions_evidential
    from mimo_unet_torch.eval.fgsm import input_gradient
    from mimo_unet_torch.models.mimo_unet import eval_mode

    ds, nb = _ev_frames(EV_PRED_N, 50), EV_PRED_N // B
    off_task, off_model = _plain_copy(task, model, dev)
    first = {k: torch.from_numpy(v[:B]).to(dev) for k, v in ds[slice(0, B)].items()}
    nll, launches = {}, None
    with _deterministic():  # FGSM gradients recomputed below, bit for bit
        for eps in (0.0, EV_EPS):
            K.reset_launch_counts()
            got = _timed_call(lambda: make_predictions_evidential(task, model, ds, B, eps), nb,
                              f"make_predictions_evidential eps={eps} B={B} (deterministic algorithms)", card)
            counted = _launches_since({k: nb * v for k, v in EVAL_LAUNCHES.items()},
                                      f"make_predictions_evidential eps={eps}")
            if eps == 0.0:
                launches = counted
            _hold_predictions(got, make_predictions_evidential(off_task, off_model, ds, B, eps),
                              f"make_predictions_evidential eps={eps}")
            x = torch.from_numpy(got[0][:B]).to(dev)
            with torch.no_grad(), eval_mode(model):
                nll[eps] = float(task.loss_fn(task.forward(model, x), first["label"],
                                              reduce_mean=True))
            if eps > 0:
                with eval_mode(model):
                    g = input_gradient(lambda xx: task.loss_fn(task.forward(model, xx),
                                                               first["label"], reduce_mean=True),
                                       first["image"])
                _check_attack(ds[slice(0, B)]["image"], got[0][:B], g.cpu(), eps,
                              "make_predictions_evidential FGSM")
    print(f"evidential NLL on the first batch: clean {nll[0.0]}, FGSM eps={EV_EPS} "
          f"{nll[EV_EPS]}")
    if not nll[EV_EPS] > nll[0.0]:
        raise AssertionError("FGSM did not raise the evidential NLL")
    return launches


def _flagship_eval(dev, card, root):
    """The flagship's make_predictions through Ensemble.from_checkpoints of
    a port checkpoint and a reference-format Lightning .ckpt the phase
    writes, at eps 0 and EV_EPS, as _ev_eval holds the evidential one."""
    import dataclasses as dc

    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.eval import make_fgsm_fn, make_predictions
    from mimo_unet_torch.eval.fgsm import input_gradient
    from mimo_unet_torch.models.ensemble import Ensemble
    from mimo_unet_torch.train.checkpoint import save_checkpoint
    from mimo_unet_torch.transforms import repeat_subnetworks

    task, model = _flagship(dev)
    state = task.init_state(1, dev)
    state.model.load_state_dict(model.state_dict())
    port_path = os.path.join(root, "flagship")
    save_checkpoint(port_path, state, task.hparams())
    other = dc.replace(task, seed=7)
    ref_path = os.path.join(root, "reference.ckpt")
    torch.save({"state_dict": {f"model._orig_mod.{k}": v.cpu() for k, v in
                               other.build_model(dev).state_dict().items()},
                "hyper_parameters": {**dc.asdict(other), "task": "mimo_unet"},
                "epoch": 0}, ref_path)
    ens = Ensemble.from_checkpoints([port_path, ref_path], return_raw_predictions=True,
                                    device=dev)
    if [t for t, _ in ens.members] != [task, other]:
        raise AssertionError("Ensemble.from_checkpoints: members out of order")
    plain = Ensemble([_plain_copy(t, m, dev) for t, m in ens.members],
                     return_raw_predictions=True)
    ds, nb = _ev_frames(EV_PRED_N, 51), EV_PRED_N // B
    first = {k: torch.from_numpy(v).to(dev) for k, v in ds[slice(0, B)].items()}
    label_rep = repeat_subnetworks(first["label"], ens.output_width)
    nll = {}
    with _deterministic():  # FGSM gradients recomputed below, bit for bit
        for eps in (0.0, EV_EPS):
            K.reset_launch_counts()
            got = _timed_call(lambda: make_predictions(ens, ds, B, eps), nb,
                              f"flagship make_predictions (2 members) eps={eps} B={B} (deterministic "
                              f"algorithms)", card)
            _launches_since({k: 2 * nb * v for k, v in EVAL_LAUNCHES.items()},
                            f"flagship make_predictions eps={eps}")
            _hold_predictions(got, make_predictions(plain, ds, B, eps),
                              f"flagship make_predictions eps={eps}")
            _, p1, p2 = make_fgsm_fn(ens, eps)(first["image"], first["label"])
            nll[eps] = float(ens.loss_fn(p1, p2, label_rep))
            if eps > 0:
                g = input_gradient(lambda x: ens.loss_fn(*ens.raw_forward_grad(x), label_rep),
                                   first["image"])
                _check_attack(ds[slice(0, B)]["image"], got[0][:B], g.cpu(), eps,
                              "flagship make_predictions FGSM")
    print(f"flagship NLL on the first batch: clean {nll[0.0]}, FGSM eps={EV_EPS} {nll[EV_EPS]}")
    if not nll[EV_EPS] > nll[0.0]:
        raise AssertionError("FGSM did not raise the flagship NLL")


def evidential(dev, card, flagship_sites):
    """Phase 15; returns the evidential kernels' stats and launches (the
    train kernels' over the three B=64 steps, the eval kernels' over the
    eps-0 make_predictions_evidential)."""
    import shutil
    import tempfile

    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.models.fast_path import fast_path_supported, train_path_supported
    from mimo_unet_torch.tasks.evidential import EvidentialUnetTask
    from mimo_unet_torch.train.checkpoint import load_checkpoint
    from mimo_unet_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    # the evidential NYUv2-depth task: S=1, fbc 32, 4 outputs, bf16, lr 1e-3
    task = EvidentialUnetTask(in_channels=3, filter_base_count=EV_F, learning_rate=1e-3,
                              compute_dtype="bfloat16")
    cfg = task.model_config
    if not (train_path_supported(cfg, (BIG_B, 1, *PATCH, 3), dev, training=True)
            and train_path_supported(cfg, (TRAIN_B, 1, *NYU, 3), dev, training=True)
            and fast_path_supported(cfg, (B, 1, *PATCH, 3), dev, training=False)):
        raise AssertionError("the evidential configuration does not take the kernel routes")

    # the kernels at the evidential call sites, beside the flagship's
    lists = {
        "eval": _redesigned(eval_sites(dev, torch.Generator(device=dev).manual_seed(40), s=1,
                                       f=EV_F, oc=EV_OC, tag=EV_TAG)),
        "train": _redesigned(_tc_marked(train_sites(
            dev, torch.Generator(device=dev).manual_seed(41), s=1, f=EV_F, oc=EV_OC,
            tag=EV_TAG))),
        "resample": _redesigned(resample_sites(
            dev, torch.Generator(device=dev).manual_seed(42), s=1, f=EV_F,
            steps=((TB, NYU),), prefix=EV_TAG)),
    }
    stats = {}
    for kind, sites in lists.items():
        stats.update(check_kernels(sites, card))
        _beside_flagship(sites, flagship_sites[kind], card)
    del lists
    torch.cuda.empty_cache()

    # one step's gradients, three steps' launches, validation, profile, times
    spe = -(-795 // BIG_B)
    state = task.init_state(spe, dev)
    _grad_check(task, state, dev, card, f32_ref=True, hw=PATCH)
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(43)
    batches = [_frames(gen, BIG_B, PATCH) for _ in range(3)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for i, batch in enumerate(batches):
        state, logs, _ = task.train_step(state, batch)
        loss = float(logs["train_loss"])
        print(f"evidential 256x256 train step {i} B={BIG_B}: loss {loss:.5f}")
        if not math.isfinite(loss):
            raise AssertionError(f"evidential step {i}: non-finite loss")
    launches = _launches_since({k: 3 * v for k, v in STEP_LAUNCHES.items()},
                               "evidential 256x256 B=64 steps")
    if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after 3 evidential steps")
    _val_after_train(task, state.model, gen)
    _profile_step(task, state, _frames(gen, BIG_B, PATCH), card, f"evidential 256x256 B={BIG_B}")
    plain = dataclasses.replace(task, ct_kernels="off")
    for b, hw in ((BIG_B, PATCH), (TRAIN_B, NYU)):
        _time_steps(task, state, gen, b, 3, card, "evidential, kernels", hw)
        pstate = plain.init_state(spe, dev)
        _time_steps(plain, pstate, gen, b, 3, card, "evidential, plain (cuDNN bf16)", hw)
        del pstate
        torch.cuda.empty_cache()
    del state

    # Trainer.fit, its last/ loaded, and the offline evaluation of both
    # families
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)  # git-ignored, not checked out
    root = tempfile.mkdtemp(prefix="chip_smoke_ev_", dir=os.path.join(REPO, "build"))
    try:
        steps = HARNESS_TRAIN // BIG_B
        trainer = Trainer(task, _harness_data(), max_epochs=1,
                          checkpoint_path=os.path.join(root, "fit"), log_every_n_steps=2,
                          log_images=False, device=dev)
        K.reset_launch_counts()
        fitted = trainer.fit()
        want = {k: steps * v for k, v in STEP_LAUNCHES.items()}
        want.update(EVAL_LAUNCHES)  # one val batch
        _launches_since(want, "evidential Trainer.fit")
        print(f"evidential Trainer.fit 1 epoch, {steps} steps: val_loss "
              f"{trainer.history[0]['val_loss']} ({card})")
        loaded_task, loaded = load_checkpoint(os.path.join(root, "fit", "last"), steps,
                                              device=dev)
        if not (isinstance(loaded_task, EvidentialUnetTask) and loaded_task == task):
            raise AssertionError(f"last/ loaded as {loaded_task!r}")
        _same_state(loaded, fitted, "evidential last/ loaded vs the trained state")
        del fitted
        ev_launches = _ev_eval(task, loaded.model, card, dev)
        del loaded
        torch.cuda.empty_cache()
        _flagship_eval(dev, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    launches.update({k: ev_launches[k] for k in EVAL_LAUNCHES})
    print(f"phase 15 (evidential task, offline evaluation): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return stats, launches


# ---- phase 16: the device-resident dataset and the host loaders -----------

DATA_PINNED, DATA_FIT, DATA_VAL = 4096, 1024, 16   # frames: pinned, fit on, validated
FRAME_BYTES = NYU[0] * NYU[1] * 4       # an NYUv2 uint8 frame (3 channels) and its depth
# NYUv2's train split in the commonly used release, about: the repo records
# no exact count, so the share below is arithmetic on this figure
NYU_TRAIN_ABOUT = 50_000
C7_B = 32                               # images of the MC predict checked on the card


class _StepRecorder:
    """A task that records, for every train step, the kernels it launched
    (the launch counters' difference: no wait on the card), its loss (a
    device scalar) and the ``row`` column of its batch where there is one;
    otherwise the task it wraps."""

    def __init__(self, task):
        self.task, self.rows, self.launches, self.losses = task, [], [], []

    def __getattr__(self, name):
        return getattr(self.task, name)

    def train_step(self, state, batch, **kw):
        from mimo_unet_torch import kernels as K

        if "row" in batch:
            self.rows.append(batch["row"])
        before = K.launch_counts()
        out = self.task.train_step(state, batch, **kw)
        self.losses.append(out[1]["train_loss"].detach())
        self.launches.append({k: v - before[k] for k, v in K.launch_counts().items()
                              if v != before[k]})
        return out

    def check_steps(self, where):
        """Every step launched exactly phase 14's train kernels."""
        bad = [i for i, got in enumerate(self.launches) if got != STEP_LAUNCHES]
        if bad:
            raise AssertionError(f"{where}: steps {bad[:5]} launched "
                                 f"{self.launches[bad[0]]}, want {STEP_LAUNCHES}")


def _frames_module(arrays, train_rows, with_rows=False, batch=TRAIN_B, val=DATA_VAL):
    """A DataModule over the first ``train_rows`` frames of ``arrays``
    (views) and the ``val`` after them, batch ``batch``; ``with_rows`` adds
    each train frame's index as a ``row`` column."""
    import numpy as np
    from mimo_unet_torch.data.core import ArrayDataset, DataModule

    class Frames(DataModule):
        batch_size = batch

        def __init__(self):
            train = {k: v[:train_rows] for k, v in arrays.items()}
            if with_rows:
                train["row"] = np.arange(train_rows, dtype=np.int64)
            self.train = ArrayDataset(train)
            self.val = ArrayDataset({k: v[train_rows:train_rows + val]
                                     for k, v in arrays.items()})

        def setup(self):
            pass

        def train_dataset(self):
            return self.train

        def val_dataset(self):
            return self.val

    return Frames()


def _pin_split(arrays, dev, card):
    """DATA_PINNED frames pinned with DeviceDataset: its gather bitwise
    numpy's indexing for a few index draws; nbytes, the budget and the
    share of NYUv2's train split that the budget would pin; one batch's
    data costs: the gather on the card, and the host-fed path's gather
    (native and numpy) and its copy into a pinned buffer, on the host's
    clock."""
    import numpy as np
    import torch
    from mimo_unet_torch.data import _native
    from mimo_unet_torch.data.core import (ArrayDataset, DeviceDataset,
                                           device_cache_budget_bytes)

    budget = device_cache_budget_bytes(dev)
    ds = ArrayDataset(arrays)
    t0 = time.perf_counter()
    pinned = DeviceDataset(ds, device=dev)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    full = NYU_TRAIN_ABOUT * FRAME_BYTES
    print(f"DeviceDataset: {len(pinned)} frames {NYU[0]}x{NYU[1]} uint8, nbytes {pinned.nbytes} "
          f"({pinned.nbytes / 1e9:.4f} GB), put on the card in {put_s:.2f} s; "
          f"device_cache_budget_bytes() before it {budget} ({budget / 1e9:.4f} GB) = "
          f"{budget // FRAME_BYTES} frames of {FRAME_BYTES} bytes = "
          f"{budget / full * 100:.2f} % of NYUv2's train split (about {NYU_TRAIN_ABOUT} frames, "
          f"{full / 1e9:.1f} GB): a full split takes the partial cache ({card})", flush=True)
    if pinned.nbytes != len(pinned) * FRAME_BYTES or pinned.data["image"].dtype != torch.uint8:
        raise AssertionError(f"DeviceDataset: {pinned.nbytes} bytes, "
                             f"{pinned.data['image'].dtype}")
    rng = np.random.default_rng(41)
    draws = [rng.integers(0, DATA_PINNED, TRAIN_B), np.sort(rng.choice(DATA_PINNED, TRAIN_B)),
             np.full(TRAIN_B, DATA_PINNED - 1), rng.permutation(DATA_PINNED)[:TRAIN_B]]
    for idx in draws:
        got = pinned.gather(torch.as_tensor(idx, device=dev))
        for k, v in got.items():
            if v.device != dev or not np.array_equal(v.cpu().numpy(), arrays[k][idx]):
                raise AssertionError(f"DeviceDataset.gather {k}: not numpy's rows {idx}")
    print(f"DeviceDataset.gather: bitwise numpy indexing for {len(draws)} index draws of "
          f"{TRAIN_B}")

    idx = draws[0]
    idx_dev = torch.as_tensor(idx, device=dev)
    batch_bytes = TRAIN_B * FRAME_BYTES
    ms, how = device_ms(lambda: pinned.gather(idx_dev), 20)
    bound = 2 * batch_bytes / PEAK_BYTES * 1e3

    def host_ms(fn, n=10):
        fn()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return sorted(ts)[n // 2]

    native = host_ms(lambda: ds[idx])
    plain = host_ms(lambda: {k: v[idx] for k, v in arrays.items()})
    batch = ds[idx]
    bufs = {k: torch.empty(v.shape, dtype=torch.uint8, pin_memory=True) for k, v in batch.items()}

    def stage():
        for k, v in batch.items():
            bufs[k].numpy()[...] = v

    staged = host_ms(stage)
    copy_ms = events_ms(lambda: [b.to(dev, non_blocking=True) for b in bufs.values()], 10)
    print(f"one B={TRAIN_B} {NYU[0]}x{NYU[1]} batch ({batch_bytes} bytes): on-card gather "
          f"{ms:.4f} ms ({how}; bound {bound:.4f} ms by bytes); host-fed: native gather "
          f"{native:.3f} ms ({_native.DEFAULT_THREADS} threads), numpy gather {plain:.3f} ms, "
          f"copy into pinned buffers {staged:.3f} ms (host clock, medians of 10), pinned copy to "
          f"the card {copy_ms:.3f} ms (events) ({card})", flush=True)
    del pinned, got
    torch.cuda.empty_cache()


def _data_fit(task, dm, dev, root, name, **kw):
    """One epoch of Trainer.fit on ``dm``: the trainer, its state, and the
    launch counters after it."""
    import torch
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.train.trainer import Trainer

    trainer = Trainer(task, dm, max_epochs=1, checkpoint_path=os.path.join(root, name),
                      log_every_n_steps=8, log_images=False, device=dev, **kw)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    state = trainer.fit()
    torch.cuda.synchronize()
    return trainer, state, K.launch_counts()


def _cached_fit(task, arrays, dev, card, root):
    """Trainer.fit(device_cache=True), one epoch of DATA_FIT frames: every
    batch gathered on the card, each step's launches phase 14's and the
    eval kernels' a validation forward, a finite loss that falls, and
    last/ loading bitwise the trained state."""
    from mimo_unet_torch.train.checkpoint import load_checkpoint

    steps = DATA_FIT // TRAIN_B
    recorder = _StepRecorder(task)
    trainer, state, _ = _data_fit(recorder, _frames_module(arrays, DATA_FIT), dev, root,
                                  "cached", device_cache=True)
    recorder.check_steps("Trainer.fit(device_cache=True)")
    want = {k: steps * v for k, v in STEP_LAUNCHES.items()}
    want.update(EVAL_LAUNCHES)  # one val batch
    launches = _launches_since(want, "Trainer.fit(device_cache=True)")
    with open(os.path.join(root, "cached", "metrics.tsv")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    print(f"Trainer.fit(device_cache=True) 1 epoch, {steps} steps {NYU[0]}x{NYU[1]} B={TRAIN_B}: "
          f"batches {dict(trainer.batches_fed)}, train losses {losses}, val "
          f"{trainer.history[0]['val_loss']}, {trainer.history[0]['throughput_images_per_sec']:.2f}"
          f" images/s, launches {launches} ({card})", flush=True)
    if dict(trainer.batches_fed) != {"cached": steps} or state.step != steps:
        raise AssertionError(f"cached fit: batches {dict(trainer.batches_fed)}, step {state.step}")
    if not (all(map(math.isfinite, losses)) and len(losses) >= 4
            and sum(losses[-2:]) < sum(losses[:2])):
        raise AssertionError(f"cached fit: the train loss does not fall: {losses}")
    _, loaded = load_checkpoint(os.path.join(root, "cached", "last"), steps, device=dev)
    _same_state(loaded, state, "Trainer.fit(device_cache=True) last/ loaded vs the trained state")


def _partial_fit(task, arrays, dev, card, root):
    """The same fit with a budget of half the split: cached and host
    batches both, every row once, each step at phase 14's launches."""
    import torch
    from mimo_unet_torch.data.core import dataset_nbytes

    steps = DATA_FIT // TRAIN_B
    dm = _frames_module(arrays, DATA_FIT, with_rows=True)
    budget = dataset_nbytes(dm.train) // 2
    recorder = _StepRecorder(task)
    trainer, state, _ = _data_fit(recorder, dm, dev, root, "partial", device_cache=True,
                                  device_cache_budget=budget)
    rows = torch.cat(recorder.rows).cpu()
    fed = dict(trainer.batches_fed)
    print(f"Trainer.fit(device_cache=True, device_cache_budget={budget}) 1 epoch: batches {fed}, "
          f"{rows.numel()} rows, {len(torch.unique(rows))} distinct, "
          f"{trainer.history[0]['throughput_images_per_sec']:.2f} images/s ({card})", flush=True)
    if not (fed.get("cached", 0) > 0 and fed.get("host", 0) > 0
            and sum(fed.values()) == steps == state.step):
        raise AssertionError(f"partial fit: batches {fed}, step {state.step}")
    if not torch.equal(torch.sort(rows).values, torch.arange(DATA_FIT)):
        raise AssertionError("partial fit: the epoch did not visit every row once")
    recorder.check_steps("partial fit")


def _fit_rates(task, arrays, dev, card, root):
    """images/s of one epoch of Trainer.fit, device_cache on and off in
    turns (on, off, off, on, on, off), with the native host gather
    serving every host-fed batch."""
    import statistics

    from mimo_unet_torch.data import _native

    dm = _frames_module(arrays, DATA_FIT)
    rates = {True: [], False: []}
    _native.reset_counts()
    for turn, cached in enumerate((True, False, False, True, True, False)):
        trainer, _, _ = _data_fit(task, dm, dev, root, f"rate{turn}", device_cache=cached)
        rates[cached].append(trainer.history[0]["throughput_images_per_sec"])
        want = {"cached" if cached else "host": DATA_FIT // TRAIN_B}
        if dict(trainer.batches_fed) != want:
            raise AssertionError(f"fit device_cache={cached}: batches {dict(trainer.batches_fed)}")
    counts = dict(_native.counts)
    print(f"host gathers by path over the host-fed fits: {counts}")
    if counts.get(("gather_rows", "numpy"), 0) or not counts.get(("gather_rows", "native"), 0):
        raise AssertionError(f"the native host gather did not serve every gather: {counts} "
                             f"({_native.build_error})")
    for cached, name in ((True, "device_cache=True"), (False, "host-fed")):
        r = rates[cached]
        print(f"Trainer.fit {name} {NYU[0]}x{NYU[1]} B={TRAIN_B}, {DATA_FIT // TRAIN_B} steps: "
              f"images/s {[round(x, 3) for x in r]}, median {statistics.median(r):.3f}, spread "
              f"{max(r) - min(r):.3f} ({card})", flush=True)
    ratio = statistics.median(rates[True]) / statistics.median(rates[False])
    print(f"Trainer.fit images/s device_cache=True / host-fed (medians): {ratio:.4f} ({card})",
          flush=True)


def _mc_predict_repeats(dev, card):
    """C.7 on the card: two MC predict calls (monte_carlo_steps=4, B=32)
    on the same images are bitwise equal, with another request between
    them; another seed moves the answer."""
    import numpy as np
    import torch
    from mimo_unet_torch.models.ensemble import Ensemble

    task, model = _flagship(dev, **MC_RECIPE)
    ens = Ensemble([(task, model)], monte_carlo_steps=MC_STEPS)
    rng = torch.Generator().manual_seed(42)
    images = torch.rand((C7_B, HW, HW, 3), generator=rng).numpy()
    other = torch.rand((C7_B, HW, HW, 3), generator=rng).numpy()
    with _deterministic():
        first = ens.predict(images, batch_size=C7_B)
        ens.predict(other, batch_size=C7_B)
        again = ens.predict(images, batch_size=C7_B)
        moved = ens.predict(images, batch_size=C7_B, seed=1)
    same = all(np.array_equal(a, b) for a, b in zip(first, again))
    shift = float(np.abs(moved[0] - first[0]).max())
    print(f"MC predict x {MC_STEPS} passes B={C7_B}: two calls bitwise equal: {same}; seed 1 "
          f"moves the mean by {shift} ({card})")
    if not same or not shift > 0:
        raise AssertionError("MC predict: two calls differ, or the seed moves nothing")


def data_layer(dev, card):
    """Phase 16: the device-resident dataset and the host loaders at the
    flagship's full width (NYUv2 640x480 frames, S=2, fbc 21, B=16)."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    arrays = _nyu_arrays(DATA_PINNED, 40, NYU)
    print(f"{DATA_PINNED} synthetic frames in NYUv2's uint8 schema made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _pin_split(arrays, dev, card)
    task = _train_task()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)  # git-ignored, not checked out
    root = tempfile.mkdtemp(prefix="chip_smoke_data_", dir=os.path.join(REPO, "build"))
    try:
        _cached_fit(task, arrays, dev, card, root)
        torch.cuda.empty_cache()
        _partial_fit(task, arrays, dev, card, root)
        torch.cuda.empty_cache()
        _fit_rates(task, arrays, dev, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del arrays
    torch.cuda.empty_cache()
    _mc_predict_repeats(dev, card)
    torch.cuda.empty_cache()
    print(f"phase 16 (device-resident dataset, host loaders): {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---- phase 17: the reference CLIs at the MIMO CLI's defaults ---------------

CLI_S, CLI_F, CLI_B = 3, 32, 32     # MIMO CLI defaults (mimo_unet_torch/cli.py): S, fbc, batch
CLI_TAG = f"S={CLI_S} fbc {CLI_F} "  # the label prefix of its kernel sites
CLI_TAG2 = f"S={CLI_S} fbc {CLI_F} C_in 2 "  # ... and of SEN12TP's two-channel sites
CLI_TRAIN, CLI_VAL = 384, 64         # synthetic NYUv2-schema frames of the train CLI's fit
SEN_SIDE = 2000                      # SEN12TP tile side: 8 x 8 windows of 256 at stride 249
SEN_TILES = {"train": 2, "val": 1, "test": 1}
SEN_WINDOWS = 64                     # windows a tile
SPEED_REPS = 200                     # measure_inference_speed --repetitions
LAUNCHES = "kernel launches: "       # the line the script runner prints its counters on
# runs a script's build_parser() and main() in a process of its own, then
# prints the kernels its run launched (each process counts its own)
SCRIPT_RUNNER = (
    "import importlib, json, sys\n"
    "from mimo_unet_torch import kernels as K\n"
    "mod = importlib.import_module(sys.argv[1])\n"
    "mod.main(mod.build_parser().parse_args(sys.argv[2:]))\n"
    f"print({LAUNCHES!r} + json.dumps(K.launch_counts()))\n")


def cli_sites(dev, card, flagship_sites):
    """The kernels at the CLI default's call sites (S=3, fbc 32, OC 2):
    eval at 256x256 B=32, train at 640x480 B=4 and 256x256 B=32, each
    against its plain version, beside the flagship's time where it has the
    same site; then K2, K5 and K7 at SEN12TP's C_in = 2 beside C_in = 3.
    Returns the two configurations' stats."""
    import torch

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    paired = {
        "eval": eval_sites(dev, gen(60), s=CLI_S, f=CLI_F, tag=CLI_TAG),
        "train": _tc_marked(train_sites(dev, gen(61), s=CLI_S, f=CLI_F, tag=CLI_TAG)),
        "resample": resample_sites(dev, gen(62), s=CLI_S, f=CLI_F, steps=((TB, NYU),),
                                   prefix=CLI_TAG),
    }
    own = (_tc_marked(train_sites(dev, gen(63), s=CLI_S, f=CLI_F, tag=CLI_TAG, b=CLI_B,
                                  hw=PATCH))
           + resample_sites(dev, gen(64), s=CLI_S, f=CLI_F, steps=((CLI_B, PATCH),),
                            prefix=CLI_TAG))
    stats = check_kernels(_redesigned([st for v in paired.values() for st in v] + own), card)
    for kind, sites in paired.items():
        _beside_flagship(sites, flagship_sites[kind], card, tag=CLI_TAG)
    del paired, own
    torch.cuda.empty_cache()

    def in_conv1(sites):
        return [st for st in sites if st.name in ("fused_double_conv9", "conv3x3_fwd",
                                                  "conv3x3_dw") and "in_conv" in st.site
                and ("conv1" in st.site or st.name == "fused_double_conv9")]

    two = in_conv1(eval_sites(dev, gen(65), s=CLI_S, f=CLI_F, tag=CLI_TAG2, cin=2))
    two += in_conv1(_tc_marked(train_sites(dev, gen(66), s=CLI_S, f=CLI_F, tag=CLI_TAG2,
                                           cin=2)))
    two += in_conv1(_tc_marked(train_sites(dev, gen(67), s=CLI_S, f=CLI_F, tag=CLI_TAG2,
                                           cin=2, b=CLI_B, hw=PATCH)))
    stats2 = check_kernels(two, card)
    for st in two:
        three = (st.name, CLI_TAG + st.site[len(CLI_TAG2):].replace("2->", "3->", 1))
        ms2, ms3 = SITE_MS[(st.name, st.site)], SITE_MS[three]
        print(f"{CLI_TAG2}{st.name} [{st.site[len(CLI_TAG2):]}] {ms2:.4f} ms vs C_in 3 "
              f"[{three[1][len(CLI_TAG):]}] {ms3:.4f} ms: ratio {ms2 / ms3:.3f} ({card})")
    del two
    torch.cuda.empty_cache()
    return stats, stats2


def _cli_fit(task, args, dm, dev, card, where):
    """cli.run_training of ``args`` on ``dm``: every step exactly phase
    14's train kernels, the eval kernels a validation batch, a finite loss
    that falls, last/ loading bitwise; images/s, step time and peak memory
    printed.  Returns (trainer, state, the launch counters)."""
    import torch
    from mimo_unet_torch import cli
    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.train.checkpoint import load_checkpoint

    steps = CLI_TRAIN // args.batch_size
    recorder = _StepRecorder(task)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    trainer, state = cli.run_training(args, recorder, dm)
    torch.cuda.synchronize()
    want = {k: steps * v for k, v in STEP_LAUNCHES.items()}
    want.update({k: -(-CLI_VAL // args.batch_size) * v for k, v in EVAL_LAUNCHES.items()})
    launches = _launches_since(want, where)
    recorder.check_steps(where)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in recorder.losses]
    rate = trainer.history[0]["throughput_images_per_sec"]
    print(f"{where}: {steps} steps {NYU[0]}x{NYU[1]} B={args.batch_size} S={task.num_subnetworks} "
          f"fbc {task.filter_base_count}: batches {dict(trainer.batches_fed)}, train losses "
          f"{[round(x, 4) for x in losses]}, val_loss {trainer.history[0]['val_loss']}, "
          f"{rate:.2f} images/s = {args.batch_size / rate * 1e3:.1f} ms a step (the epoch after "
          f"its first step), peak memory {peak:.2f} GiB, launches {launches} ({card})",
          flush=True)
    fed = {"cached" if args.device_cache else "host": steps}
    if dict(trainer.batches_fed) != fed or state.step != steps:
        raise AssertionError(f"{where}: batches {dict(trainer.batches_fed)}, step {state.step}")
    if not (all(map(math.isfinite, losses)) and sum(losses[-2:]) < sum(losses[:2])):
        raise AssertionError(f"{where}: the train loss does not fall: {losses}")
    _, loaded = load_checkpoint(os.path.join(args.checkpoint_path, "last"), steps, device=dev)
    _same_state(loaded, state, f"{where} last/ loaded vs the trained state")
    return trainer, state, launches


def cli_train(dev, card, root):
    """The NYUv2 train CLI at its defaults (S=3, fbc 32, B=32, bf16) on
    in-memory NYUv2-schema 640x480 frames, host-fed and with
    --device_cache; then step times at 640x480 and 256x256, B=32, and a
    profile of one 640x480 step.  Returns
    the host-fed run's launches and its checkpoint."""
    import torch
    from mimo_unet_torch import cli
    from mimo_unet_torch.scripts.train import train_nyuv2_depth

    argv = ["--checkpoint_path", root, "--dataset_dir", root, "--seed", "1", "--max_epochs", "1"]
    args = train_nyuv2_depth.build_parser().parse_args(argv)
    print(f"train_nyuv2_depth {' '.join(argv)}: {vars(args)}")
    task = cli.build_mimo_task(args, in_channels=3, out_channels=args.num_loss_function_params)
    if (task.num_subnetworks, task.filter_base_count, args.batch_size, task.compute_dtype,
            args.device) != (CLI_S, CLI_F, CLI_B, "bfloat16", "cuda"):
        raise AssertionError(f"the CLI's defaults moved: {task}, {vars(args)}")
    arrays = _nyu_arrays(CLI_TRAIN + CLI_VAL, 70, NYU)
    dm = _frames_module(arrays, CLI_TRAIN, batch=args.batch_size, val=CLI_VAL)
    runs = {}
    for cached in (False, True):
        name = "cached" if cached else "host"
        args.device_cache = cached
        args.checkpoint_path = os.path.join(root, name)
        os.makedirs(args.checkpoint_path)
        runs[name] = _cli_fit(task, args, dm, dev, card,
                              f"train_nyuv2_depth (cli.run_training{', --device_cache' * cached})")
    _, state, launches = runs["host"]
    del runs, arrays, dm
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(72)
    for hw in (NYU, PATCH):
        _time_steps(task, state, gen, CLI_B, 3, card, f"S={CLI_S} fbc {CLI_F} (CLI defaults)", hw)
    _profile_step(task, state, _frames(gen, CLI_B, NYU), card,
                  f"S={CLI_S} fbc {CLI_F} {NYU[0]}x{NYU[1]} B={CLI_B}")
    del state
    torch.cuda.empty_cache()
    return launches, os.path.join(root, "host", "last")


def _sen_tiles(root):
    """SEN12TP tiles as ``.npz`` of the bands the NDVI scripts read (the
    real band names; float32 in their physical ranges), seeded."""
    import numpy as np

    rng = np.random.default_rng(73)
    shape = (SEN_SIDE, SEN_SIDE)
    for split, n in SEN_TILES.items():
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            np.savez(os.path.join(root, split, f"tile_{i}.npz"),
                     VV_sigma0=rng.uniform(-30, 0, shape).astype(np.float32),
                     VH_sigma0=rng.uniform(-40, 0, shape).astype(np.float32),
                     B04=rng.uniform(0, 1e4, shape).astype(np.float32),
                     B08=rng.uniform(0, 1e4, shape).astype(np.float32))


def _run_script(module, argv, where, timeout=400):
    """``module``'s build_parser() and main() in a process of its own; its
    output lines and the kernels it launched."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SCRIPT_RUNNER, module, *map(str, argv)],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{where}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    launches = json.loads([ln for ln in lines if ln.startswith(LAUNCHES)][-1][len(LAUNCHES):])
    print(f"{where}: exit 0 in {time.perf_counter() - t0:.1f} s (its process: start, kernel "
          f"load, run), launches {({k: v for k, v in launches.items() if v})}", flush=True)
    return lines, launches



def cli_ndvi(dev, card, root, have_pandas):
    """train_ndvi and train_ndvi_evidential whole at their defaults (S=3
    fbc 32 and fbc 32, B=32, patch 256, stride 249, VV/VH -> NDVI), one
    epoch; then test_ndvi and test_ndvi_evidential on their checkpoints,
    whole where pandas imports, else their prediction step here.  Returns
    train_ndvi's launches and checkpoint."""
    import numpy as np
    from mimo_unet_torch import kernels as K

    sen = os.path.join(root, "sen12tp")
    t0 = time.perf_counter()
    _sen_tiles(sen)
    print(f"SEN12TP tiles written: {SEN_TILES} of {SEN_SIDE}x{SEN_SIDE}, 4 bands float32, "
          f"{time.perf_counter() - t0:.1f} s")
    steps = SEN_TILES["train"] * SEN_WINDOWS // CLI_B
    want_train = {k: steps * v for k, v in STEP_LAUNCHES.items()}
    want_train.update({k: SEN_TILES["val"] * SEN_WINDOWS // CLI_B * v
                       for k, v in EVAL_LAUNCHES.items()})
    test_batches = -(-SEN_TILES["test"] * SEN_WINDOWS // 5)  # the test scripts' --batch_size 5
    want_test = {k: test_batches * v for k, v in EVAL_LAUNCHES.items()}
    out = {}
    for family, out_channels in (("", 2), ("_evidential", 4)):
        ck = os.path.join(root, "ndvi" + family)
        os.makedirs(ck)
        where = f"train_ndvi{family}"
        lines, launches = _run_script(
            f"mimo_unet_torch.scripts.train.train_ndvi{family}",
            ["--checkpoint_path", ck, "--dataset_dir", sen, "--seed", 1, "--max_epochs", 1,
             "-i", "VV_sigma0", "-i", "VH_sigma0", "-t", "NDVI"], where)
        for ln in lines:
            if ln.startswith("[epoch"):
                print(f"{where}: {ln} (256x256 B={CLI_B}, C_in 2; {card})")
        _want_launches(launches, want_train, where)
        with open(os.path.join(ck, "last", "hparams.json")) as f:
            hp = json.load(f)
        if (hp["in_channels"], hp["out_channels"], hp["filter_base_count"]) != (2, out_channels,
                                                                               CLI_F):
            raise AssertionError(f"{where}: hparams {hp}")
        print(f"{where}: hparams.json in_channels {hp['in_channels']}, out_channels "
              f"{hp['out_channels']}, task {hp['task']}")
        out[family] = (launches, os.path.join(ck, "last"))

        test = f"test_ndvi{family}"
        flag = "--model_checkpoint_path" + ("" if family else "s")
        argv = [flag, os.path.join(ck, "last"), "--result_dir", os.path.join(root, test),
                "--dataset_dir", os.path.join(sen, "test")]
        if have_pandas:
            _, launches = _run_script(f"mimo_unet_torch.scripts.test.{test}", argv, test)
            preds = [np.load(os.path.join(root, test, f"{k}.npy"))
                     for k in ("y_preds", "aleatoric_vars", "epistemic_vars")]
            for name in ("df_pixels.pkl", "precision_recall.csv", "calibration.csv"):
                if not os.path.getsize(os.path.join(root, test, name)):
                    raise AssertionError(f"{test}: {name} is empty")
        else:
            launches, preds = _ndvi_predictions(test, argv, dev)
        _want_launches(launches, want_test, test)
        n = SEN_TILES["test"] * SEN_WINDOWS
        if not (all(p.shape == (n, 256, 256) and np.isfinite(p).all() for p in preds)
                and (preds[1] >= 0).all() and (preds[2] >= 0).all()):
            raise AssertionError(f"{test}: predictions not finite, of shape ({n}, 256, 256) "
                                 f"with variances >= 0")
        print(f"{test}: {n} windows in {test_batches} batches of 5, eval kernels once a batch "
              f"and member, predictions finite, variances >= 0")
        K.reset_launch_counts()
    return out[""]


def _ndvi_predictions(test, argv, dev):
    """The prediction step of test_ndvi[_evidential] on the card (what the
    script runs before pandas writes its frames): the kernels it launched
    and (y_preds, aleatoric, epistemic)."""
    import importlib

    from mimo_unet_torch import kernels as K
    from mimo_unet_torch.eval import make_predictions, make_predictions_evidential
    from mimo_unet_torch.models.ensemble import Ensemble
    from mimo_unet_torch.scripts.test.test_ndvi import load_dataset
    from mimo_unet_torch.train.checkpoint import load_checkpoint

    args = importlib.import_module(f"mimo_unet_torch.scripts.test.{test}").build_parser(
        ).parse_args(argv)
    dataset = load_dataset(args)
    K.reset_launch_counts()
    if test == "test_ndvi":
        ens = Ensemble.from_checkpoints(args.model_checkpoint_paths,
                                        return_raw_predictions=True, device=dev)
        preds = make_predictions(ens, dataset, batch_size=args.batch_size)
    else:
        task, state = load_checkpoint(args.model_checkpoint_path, device=dev)
        preds = make_predictions_evidential(task, state.model, dataset,
                                            batch_size=args.batch_size)
    print(f"{test}: its prediction step on the card (pandas missing: the frames and curves "
          f"left out)")
    return K.launch_counts(), preds[1:4]


def cli_speed(card, nyu_ckpt, ndvi_ckpt):
    """measure_inference_speed whole on the NYUv2 checkpoint at 480x640
    and the NDVI one at 256x256."""
    for ckpt, c, h, w in ((nyu_ckpt, 3, NYU[0], NYU[1]), (ndvi_ckpt, 2, HW, HW)):
        where = f"measure_inference_speed {h}x{w} C_in {c}"
        lines, _ = _run_script("mimo_unet_torch.scripts.test.measure_inference_speed",
                               ["--model_checkpoint_paths", ckpt, "--in_channels", c,
                                "--height", h, "--width", w, "--repetitions", SPEED_REPS], where)
        shown = [ln for ln in lines if ln.startswith(("mean: ", "per-exec (events): "))]
        if len(shown) != 2:
            raise AssertionError(f"{where}: want its two lines, got {lines[-5:]}")
        for ln in shown:
            print(f"{where} (S={CLI_S} fbc {CLI_F}, 1 image, {SPEED_REPS} repetitions): {ln}")


def cli_phase(dev, card, flagship_sites):
    """Phase 17; returns the kernel stats and launches of the S=3 fbc 32
    configuration and of its C_in = 2 sites."""
    import importlib.util
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("h5py", "pandas", "matplotlib")}
    print("phase 17: " + ", ".join(f"{m} {'imports' if v else 'missing'}"
                                   for m, v in have.items()), flush=True)
    print("phase 17 leaves out: test_nyuv2_depth and test_nyuv2_depth_evidential (their data "
          "is .h5; their prediction step is phase 15's); train_nyuv2_depth's h5 loader "
          f"({'not needed' if have['h5py'] else 'h5py missing'}: the CLI's task and "
          "run_training run on in-memory frames)")
    if not have["pandas"]:
        print("phase 17 leaves out for want of pandas: test_ndvi's and test_ndvi_evidential's "
              "frames and curves (df_pixels.pkl, precision_recall.csv, calibration.csv)")
    if not have["matplotlib"]:
        print("phase 17 leaves out for want of matplotlib: the train scripts' monitor image "
              "grids (Trainer logs their failure and trains on)")
    stats, stats2 = cli_sites(dev, card, flagship_sites)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)  # git-ignored, not checked out
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=os.path.join(REPO, "build"))
    try:
        launches, nyu_ckpt = cli_train(dev, card, root)
        torch.cuda.empty_cache()
        launches2, ndvi_ckpt = cli_ndvi(dev, card, root, have["pandas"])
        cli_speed(card, nyu_ckpt, ndvi_ckpt)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 17 (the reference CLIs at S={CLI_S} fbc {CLI_F}, SEN12TP C_in 2): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return stats, launches, stats2, launches2


def main() -> int:
    import torch

    # ---- 1. the card ------------------------------------------------------
    # large steps (B=64 at 640x480) fragment the caching allocator
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: CUDA is not available")
    sys.path.insert(0, REPO)
    from mimo_unet_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    built = _build.build_seconds
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({'nvcc ' + format(built, '.2f') + ' s' if built else 'cached'})",
          flush=True)
    tensor_core_report()

    # ---- 3-12 ---------------------------------------------------------------
    os.environ[X2_HALF] = "0"  # the default decoder until phase 13
    from mimo_unet_torch import kernels as K

    flag_eval = eval_sites(dev, torch.Generator(device=dev).manual_seed(0))
    stats = check_kernels(_redesigned(flag_eval), card)
    flagship_sites = {"eval": [(st.name, st.site) for st in flag_eval]}
    del flag_eval
    torch.cuda.empty_cache()
    extra, same = eval_extra_sites(dev, torch.Generator(device=dev).manual_seed(9))
    check_kernels(extra, card)  # times of these sites: printed, not summed
    for name, half, full in same:
        compare(f"{name} x2_half_h vs its full-res form", half(), full(), True)
        print(f"{name} x2_half_h: bitwise its full-res form fed the lerped x2")
    del extra, same
    torch.cuda.empty_cache()
    served = serve(dev, card)
    torch.cuda.empty_cache()
    serve_baselines(dev, card)
    serve_profile(dev, card)
    torch.cuda.empty_cache()
    flag_train = train_sites(dev, torch.Generator(device=dev).manual_seed(1))
    flagship_sites["train"] = [(st.name, st.site) for st in flag_train]
    stats.update(check_kernels(_redesigned(_tc_marked(
        flag_train + elem_sites_256(dev, torch.Generator(device=dev).manual_seed(11)))), card))
    del flag_train
    torch.cuda.empty_cache()
    trained = train(dev, card)
    torch.cuda.empty_cache()
    stats.update(check_kernels(_redesigned(
        dropout_kernel_sites(dev, torch.Generator(device=dev).manual_seed(2))), card))
    torch.cuda.empty_cache()
    served_mc = serve_mc(dev, card)
    torch.cuda.empty_cache()
    trained_mc, final = train_mc(dev, card)
    torch.cuda.empty_cache()
    flag_resample = resample_sites(dev, torch.Generator(device=dev).manual_seed(3))
    flagship_sites["resample"] = [(st.name, st.site) for st in flag_resample
                                  if f"{NYU[0]}x{NYU[1]} B={TB}" in st.site]
    stats.update(check_kernels(_redesigned(flag_resample), card))
    del flag_resample
    torch.cuda.empty_cache()
    patch = train_patch(dev, card)
    torch.cuda.empty_cache()
    train_tail(dev, card)
    torch.cuda.empty_cache()

    # ---- 13. the x2-half train decoder ---------------------------------------
    stats.update(check_kernels(_redesigned(
        x2_half_sites(dev, torch.Generator(device=dev).manual_seed(5))), card))
    torch.cuda.empty_cache()
    half_sites, same = x2_half_conv_sites(dev, torch.Generator(device=dev).manual_seed(6))
    check_kernels(_redesigned(half_sites), card)  # times: printed, not summed
    for name, half, full in same:
        compare(f"{name} x2_half_h vs fed K13's output", half(), full(), True)
        print(f"{name} x2_half_h: bitwise its full-res form fed K13's output")
    del half_sites, same
    torch.cuda.empty_cache()
    halfed = train_x2_half(dev, card)
    torch.cuda.empty_cache()

    # ---- 14. the train harness and the remat rungs ---------------------------
    train_harness(dev, card)
    launches = {k.__name__: served[k.__name__] for k in K.EVAL_KERNELS}
    launches.update({k.__name__: trained[k.__name__] for k in K.TRAIN_KERNELS})
    launches["conv1x1"] = served_mc["conv1x1"]
    launches["conv1x1_bwd"] = final["conv1x1_bwd"]
    launches.update({k.__name__: patch[k.__name__] for k in K.RESAMPLE_KERNELS})
    launches.update({k.__name__: halfed[k.__name__] for k in K.X2_HALF_KERNELS})

    # ---- 15. the evidential task and the offline evaluation ------------------
    torch.cuda.empty_cache()
    ev_stats, ev_launches = evidential(dev, card, flagship_sites)

    # ---- 16. the device-resident dataset and the host loaders ----------------
    torch.cuda.empty_cache()
    data_layer(dev, card)

    # ---- 17. the reference CLIs at the MIMO CLI's defaults ---------------------
    torch.cuda.empty_cache()
    cli_stats, cli_launches, two_stats, two_launches = cli_phase(dev, card, flagship_sites)

    # ---- 18. results -------------------------------------------------------
    rows = [{"name": k, "route": "cuda", "source": KERNEL_INFO[k][0],
             "replaces": KERNEL_INFO[k][1], "launches": launches[k], **stats[k]}
            for k in KERNEL_INFO]
    rows += [{"name": f"{k} (evidential S=1 fbc {EV_F})", "route": "cuda",
              "source": KERNEL_INFO[k][0], "replaces": KERNEL_INFO[k][1],
              "launches": ev_launches[k], **ev_stats[k]}
             for k in KERNEL_INFO if k in ev_stats]
    rows += [{"name": f"{k} ({what})", "route": "cuda", "source": KERNEL_INFO[k][0],
              "replaces": KERNEL_INFO[k][1], "launches": counts[k], **st[k]}
             for what, st, counts in ((f"S={CLI_S} fbc {CLI_F}", cli_stats, cli_launches),
                                      (f"S={CLI_S} fbc {CLI_F} C_in 2", two_stats, two_launches))
             for k in KERNEL_INFO if k in st]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
