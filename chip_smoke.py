#!/usr/bin/env python3
"""Drive the PyTorch port's int8 serving paths (U-Net and ReLayNet), the
U-Net's w4a4 serving mode and fused head, its U-Net training path (with and
without the fused Dice+CE loss), SDNet's forward and composite train step,
the real-data path (Duke DME volumes through ``train --data`` and
``eval --data``), the zoo's first models (Y-Net plain and FFC, EdgeAL,
FourierNet, AnoGAN), MGU-Net (both variants), ISLAM and LightReSeg, and
MSNet, M2SNet, BioNet, WAT-Net, Masood and RetiFluidNet, the mixed int8
graph, the parallel runtime on two ranks of the card, the remat step, the
generic blocks and the packed U-Net step data-parallel on two ranks once
on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises; the exit code is then non-zero):

1. device: card name and power limit, versions, compute capability 9.0,
   and the build of the CUDA kernels from ``csrc/``;
2. kernels: every stage of the served graph (f=32, 512x512, batch 2) on
   its kernel and on the kernel's plain PyTorch version, bit for bit; K1's
   plan at each stage (the stem must be on its stem body, the 17 other
   stages on its mma.sync body) and K2's; K2 called twice at ct0 and ct3
   (the same bits), at +-127 inputs and weights (ct0) and where the pixels
   are not a multiple of its tile, bit for bit; K1's stem body at +-127
   inputs and weights, at f=16, at an edge shape (80 x 48), with border
   values a wrong halo would change, and called twice, bit for bit;
3. graph: the U-Net (f=32, 10 classes, seeded random weights), folded,
   calibrated and quantized; labels of the kernel graph identical to the
   plain graph's at batch 8, and agreeing with the all-int8 oracle
   (> 0.995) and the float graph (> 0.95);
4. serve: the ServingLoop and HTTP server built as the CLI builds them,
   12 requests from 3 client threads; every response equals the direct
   forward, and every forward launched K1 18 times, K2 4 times, K3 once;
5. times on the card (CUDA events; K1 and K2 also device time): each
   kernel against its plain version at batch 32, every K1 stage also
   against its dp4a body through that body's own entry point
   (bit-equal), the stem with its bound's share, GB/s and the device time
   of ``zero_()`` on a tensor of its output's shape (a write-rate
   yardstick), K2's four calls with their bound's share, GB/s and TOPS,
   the served forward at batch 32 and 128 with a profile at 32, serve
   latency;
6. training kernels: K4 (forward and dgrad) and K5 at the 17 non-stem 3x3
   conv shapes of the f=32 U-Net at 512x512, batch 8 (the train step's),
   on integer inputs, bit-equal to the plain versions; K6 in both modes at
   the 18 BatchNorm shapes, batch 8, within rtol 1e-6 of the float64 plain
   version (N(1, 1) inputs), a second call bit-identical, its plan printed,
   and at 512^2 x 32 and 32^2 x 512 (batch 2, both modes) bit-equal to the
   numpy emulation of its order of additions
   (``tests/test_torch_k6_order.py``); K5 twice on the same random inputs at the
   default step's three K5 shapes, bit-identical (its fixed-order sums);
   K4 at the default step's six calls on random inputs, within one bf16
   ulp plus 2^-16 of the sum of |products| of the float64 plain version,
   and a second call bit-identical;
7. train: the trainer as ``cli train --packed`` builds it (f=32, 10 classes,
   512x512 synthetic data, batch 8, Adam 1e-3), five steps: loss finite and
   lower at step 5 than at step 1, and K4/K5/K6 launched 6/3/36 times per
   step; from the state those steps reached, one step on the kernels
   against the same step with the plain versions patched in (``GATE``:
   loss, and per gradient tensor above a norm of 1e-3 the cosine and the
   norm), and four planted kernel faults that this gate must reject (K4
   leaving out every 64th of its tiles, K5 every 64th of its bands, K6
   sums 0.5% high, K6 leaving out the rows of one block of its plan);
   launches per step with ``mid=deep="kernel"`` 34/17/36;
8. times on the card: each training kernel summed over the step's calls at
   batch 8 against its plain version and one library call; K4's device
   time (``torch.profiler``) and plan per call beside its event time and
   the WMMA body's, summed over the default step's six calls against the
   library's and over all 17 convs; K5's device
   time (both passes) per call, summed over the default
   step's three calls and over all 17 convs, beside ``conv2d_weight``'s,
   the bound and the GB/s achieved on the bound's bytes; K6's and the
   library's device time per BatchNorm shape beside their event times;
   the train step at batch 8 and 16 in both conv settings (and the
   library-conv step), peak memory, and a ``torch.profiler`` breakdown of
   the step (kernels a step per kernel group; the rest split by the port
   function that launched it, through ``record_function`` wrappers put in
   by this script);
9. fused-loss kernels: K8 and K9 at the train step's logits (8, 512, 512,
   10) bf16 with int64 labels, uniform and class weights: K8 within rtol
   1e-5 of the float64 plain version and a second call bit-identical to
   the first (its plan printed), K9 within one bf16 ulp of the float64
   dlogits (plus an fp32 floor of 2^-20 of the largest);
10. fused-loss training: five steps of ``cli train --packed`` with
    ``OCTSEG_PACKED_FUSED_LOSS=1``: loss finite and falling, K8/K9
    launched once each per step (K4-K6 as in phase 7); from the state
    those steps reached, the fused step against the unfused step
    (``FUSED_GATE``) and two planted K8/K9 faults the gate must reject;
11. times: K8 and K9 against their plain versions (device time, share of
    the bound's rate, must and aim), both losses' forward +
    backward, and the train step at batch 8 with and without the fused
    loss (in turns: unfused, fused, fused, unfused);
12. ReLayNet kernels: K7 at its 7 stage shapes (f=64, 512x512, batch 2),
    bit for bit against its plain version (pool values and indices too),
    a second call at b0 and b6 bit-identical to the first, and at the b0
    and b6 shapes (with the pool) inputs whose 2x2 windows all tie (index
    0) and inputs and weights all +-127 (|acc| up to 43,354,368 at b6);
13. ReLayNet graph (f=64, 10 classes, seeded random weights, batch 8):
    labels identical to the plain graph's, agreement with the all-int8
    oracle > 0.995 and the float graph > 0.95;
14. ReLayNet served as ``cli serve --model relaynet`` builds it: 6 HTTP
    requests, each equal to the direct forward; K7 7 and K3 1 launches
    per forward;
15. ReLayNet times at batch 32: K7 per stage and summed (event time and
    device time, TOPS), against its plain version and its bound, and the
    served forward with a ``torch.profiler`` breakdown;
16. K10 (the fused stem) and K11 (the int8 pool) bit for bit against their
    plain versions: K10 on its mma.sync body at (2, 512, 512) with f=32
    (the graph's tensor-core packs given, and a second call that must
    give the same bits), at the non-square (2, 80, 48), at +-127 inputs
    and weights, and on a border case (stem biases up to 40) where a halo
    holding the stem of a zero-padded image must change outputs; on its
    dp4a body at (2, 512, 512) with f=16; each call's body as the plan
    chose it; K11 at the packed graph's deep pool shapes (batch 2) and a
    C=24 shape;
17. the PSRP graph of phase 3 with the fused stem: labels identical to the
    unfused graph's and to its plain graph's at batch 8, launches per
    forward K10 1, K1 16, K2 4, K3 1, and K10's plan there;
18. the row-packed graph (``infer --quantize packed``) of the same model at
    batch 8: labels identical to its plain graph's, agreement with the
    all-int8 oracle > 0.995 and the float graph > 0.95, launches per
    forward K1 18, K11 2, K2 4, K3 1;
19. ``cli infer`` at 512x512 on 4 B-scans: ``--quantize packed`` and
    ``psrp``, ``--save-quantized`` then ``--load-quantized`` writing the
    same masks, ReLayNet ``psrp``;
20. ``cli eval --quantize psrp`` at 512x512, ``--num-val 8``: the confusion
    counts sum to the pixel count, and the metrics equal the same masks
    scored on the CPU within 1e-4;
21. times at batch 32: K10's mma.sync body, its dp4a body (its own entry
    point) and K1 (stem) + K1 (blk0_conv1, pool), in turns, each with its
    event and device times, K10's plan, bound and share of the bound's
    rate; K11 against its bound and one PyTorch call (``amax``), the
    packed forward and the PSRP forward with the fused stem off and on at
    batch 32 and 128 (in turns), and ``Trainer.evaluate`` per batch of 8;
22. K12 (SDNet's column softmax, position and std) against its plain
    version at (8, 3, 512, 512), (8, 11, 512, 512), (2, 5, 100, 200) and
    (1, 2, 600, 96) (H > 512: the three-pass body), each with its plan: sm
    within 1e-6, pos and std within 1e-5 * H, its backward within 1e-5 of
    autograd through the plain version, a one-hot column (std = 0) without
    a std cotangent giving a finite gradient; K6 at SDNet's BatchNorm
    shapes (C = 1, the dense features' 4 rows, 16 channels);
23. ``cli smoke --model all --strict`` (one ``ok`` line for every registry
    name, a failing model raises), then SDNet at full width (channels
    32-512, 4 classes, 512x512, batch 8, eval) built as the registry builds
    it: K12 once per forward, the forward against the same forward on the
    plain versions (masks 1e-5, positions 1e-5 * H, hard-anatomy values
    that round the other way counted), and the card against the CPU on two
    128x128 crops with TF32 off;
24. ``SDNetTrainer`` (Adam at its default 1e-4) five steps on one batch of
    4 synthetic B-scans and one noise draw, cuDNN deterministic: loss
    finite and lower at step 5, K12 once and K6 96 times per step; from the
    trained state, on the segmentation half of the loss,
    the step with K12 against the step with its plain version and the step
    with every kernel against every plain version (``SDNET_GATE``, which a
    planted K6 fault must fail), the whole loss shown ungated;
25. times: K12 against its plain version and bound at both batch-8
    shapes and the step's (4, 3, 512, 512), each device time's share of
    the bound's rate, must and aim, the SDNet forward at batch 8, the
    train step at batch 4 and its
    peak memory, a ``torch.profiler`` breakdown of the step;
26. K1 and K2 with the w4a4 knobs bit for bit against their plain versions
    at every stage of the f=32 512x512 graph (batch 2) in the modes w4a4,
    w4 and a4, with each mode's quantized weights and epilogues (-7
    borders, clip 7, the split-scale pool, ct0/ct1's per-column bias), on
    seeded inputs in the range each stage reads; K1's fused head at
    blk8_conv1's shape (int8 and w4a4 qparams);
27. the w4a4, w4 and a4 graphs of phase 3's U-Net at batch 8: labels
    identical to their plain graphs', launches K1 18, K2 4, K3 1 per
    forward; agreement with the all-int8 oracle, float and the int8 PSRP
    graph printed;
28. the fused head: labels identical to the unfused graph's (int8 and
    w4a4), launches K1 18, K2 4, K3 0;
29. ``cli infer --quantize int4`` with ``--save-quantized`` then
    ``--load-quantized`` (identical masks), ``cli eval --quantize int4``
    (confusion sum = pixels), and the int4 graph served as ``cli serve
    --quantize int4`` builds it: 5 HTTP requests, each equal to the direct
    forward, launches as phase 4's;
30. times at batch 32: K1 and K2 per w4a4 stage (events and device time)
    against the plain versions and the bound, summed per TPU kernel, K2
    beside its int8 call at the same stage; K1
    with the fused head against K1 then K3; P3's counterpart, K1 at the
    deep widths (128, 256, 512 channels) on +-7 against int8 values and
    with clip 7 against 127; the served forward int8, w4a4 and with the
    fused head at batch 32 and 128, in turns;
31. the real-data path: four synthetic Duke DME v5 volumes in the
    published layout (496x768x61 uint8, 11 annotated B-scans,
    ``manualLayers1`` (8, 768, 61), ``manualFluid1``) written from ``SEED``;
    ``cli train --data duke:DIR --packed`` (f=32, 512x512, batch 8, one
    epoch, ``--checkpoint-dir``; K4, K5 and K6 launched) and ``cli eval
    --data duke:DIR --quantize psrp --checkpoint`` on the file that train
    wrote (K1, K2, K3 launched; the
    metrics equal the same masks scored on the CPU within 1e-4, the
    confusion counts exactly); ``preprocess(flatten=True, denoise=True)``
    on one batch on the card and on the CPU (surfaces equal, values within
    1e-5); a RETOUCH case (49x496x512 uint16, zlib) read by
    ``load_mhd_volume`` and by the native ``PrefetchReader`` (equal
    arrays); ``serve --quantize int8``, ``off`` and ``psrp
    --load-quantized`` (an ``infer --save-quantized`` artifact) answering
    HTTP requests with the direct forward's labels; ``infer --image-dir``
    on PNGs where PIL or cv2 is installed; the five metric families on
    CUDA tensors against the CPU within 1e-4; each step's seconds;
32. the zoo's first models at the JAX defaults' full width from seed 0:
    Y-Net-FFC and Y-Net (f=32, 10 classes): the eval forward on the card
    against the CPU at 128x128 with TF32 off (1e-4 of the largest
    output), the forward at batch 8 in bf16 (CUDA events, median of 5),
    one ``cli train`` epoch of 4 steps at batch 8 (K6 launched 70 / 52
    times a step), the step's ms, peak memory and a profile (K6 kernels a
    step, idle share); for Y-Net-FFC the K6 gate (``k6_gate``: a float32
    step from the trained state, TF32 off, cuDNN deterministic, K6 against
    its plain version at ``ZOO_K6_GATE``, the same step twice bit-equal,
    the one-ulp floor beside it, and a planted K6 fault that must fail the
    gate); EdgeAL (ngf 64, 9
    blocks, 3 classes): card vs CPU at 64x64, the forward and one
    ``cli train`` step at batch 4; FourierNet (features 16-256):
    ``prepare_dataset`` on 8 synthetic masks (host seconds),
    ``FourierNetTrainer.fit`` for 2 epochs at batch 4, ``predict``, card
    vs CPU at 128x128; AnoGAN: 5 + 5 ``AnoGANTrainer`` steps at 64x64,
    batch 64, finite losses, ms a step, K6 launched;
33. MGU-Net and MGU-Net-2 (feature_scale 4), ISLAM (single head) and
    LightReSeg at the JAX defaults' full width from seed 0, 10 classes:
    the eval forward on the card against the CPU with TF32 off (1e-4 of
    the largest output; ``ZOO2_CARD_VS_CPU``: MGU-Net at 160x160 also
    with ``is_deconv=False``, MGU-Net-2, ISLAM also with three heads and
    the Gaussian pair, and LightReSeg with every ``gamma`` 0.5, at
    128x128); the forward at batch 8 in bf16; one ``cli train`` epoch of 4
    steps (MGU-Nets at batch 8, the others at 4) with K6's launches a step
    equal to ``ZOO2``'s count (44, 44, 110, 38); the step's ms, peak
    memory and profile; K6 against its plain version on seeded bf16
    channels-last inputs at every shape the bf16 step gives a BatchNorm
    whose channels are not a multiple of 8 (K6's one-channel-a-lane path;
    ISLAM's 97, 81 and 27, LightReSeg's head at 10 classes), both modes,
    relative error within 1e-6 and a bit-equal repeat; on ISLAM and
    LightReSeg the K6 gate as in phase 32.
34. MSNet and M2SNet (Res2Net-50), BioNet (ResNet-18), WAT-Net, Masood
    and RetiFluidNet at the JAX defaults' full width from seed 0, 10
    classes: the eval forward on the card against the CPU at 128x128 with
    TF32 off (1e-4 of the largest output; BioNet's three outputs;
    RetiFluidNet, its SDA convs redrawn off the saturation of the published
    ones, on its probability channels, its one-hot bicon maps equal where
    the CPU's top two probabilities are more than 1e-5 apart); Masood's
    GLCM features of 8 B-scans at 512^2, levels and matrices equal; the
    bf16 forward at batch 8 with its peak memory; one ``cli train`` epoch
    of 4 steps (RetiFluidNet at batch 4, the others at 8) with K6's
    launches a step equal to ``ZOO3``'s count (218, 298, 40, 40, 36);
    BioNet, which no trainer takes, one train-mode forward and backward
    of its outputs' mean in the phase (K6 96); each step's ms, peak
    memory and profile; ``k6_odd_channels`` on the M2SNet step (Res2Net's
    26- and 52-channel BatchNorms); the K6 gate on M2SNet (its shared
    filters' BatchNorms run four times a unit) and WAT-Net (1024-channel
    BatchNorms, shared WAT gates).
35. the rest of the JAX package: the mixed int8 graph of phase 3's U-Net
    (``quantize_unet_mixed`` / ``unet_mixed_forward``) in both shallow
    modes at batch 8: K1 against its plain version (0 label mismatches),
    10 K1 launches a forward, agreement with ``folded_forward``, the
    all-int8 oracle and ``deep="xla"``; its forwards at batch 32 beside
    the PSRP graph's (CUDA events, two turns); two ranks started by
    ``parallel/launch.run_ranks`` (gloo, both on the one card): what gloo
    does with CUDA tensors (all_reduce, broadcast, all_gather; send/recv
    in ranks of its own), the f=32 U-Net (float32, TF32 off, cuDNN
    deterministic) and the int8 oracle H-sharded at 512x512, batch 2,
    against unsharded (the oracle bit for bit, the float U-Net's labels
    equal and its logits within ``SPATIAL_FLOAT_TOL``; the first module
    that differs, and the conv shapes whose halo'd halves differ in one
    process), ``dp_serve`` of the PSRP graph at batch 8 against one rank,
    the Y-Net step on two ranks of 4 against one rank on the batch of 8
    (float32, TF32 off, cuDNN deterministic; ``DP_GATE``, the ranks'
    parameters equal, K6 launches a step); ``cli infer --spatial 2``
    (off and int8, 4 B-scans; the command starts its ranks) against
    ``--spatial 1``; ``dryrun_multichip(2)`` on the card (it starts its
    ranks, gloo, both on card 0); the generic step with ``remat="full"`` against the
    plain step (U-Net f=32, batch 8, float32: loss, gradients and running
    statistics equal, K6 launches, peak memory); the generic blocks and
    AttU_Net4 card against CPU, eval and train, 1e-4.
36. the packed U-Net step under a data axis of two ranks (gloo, both on
    the one card; f=32, 10 classes, 512x512), from phase 7's trained
    state: the step on 2 ranks x 4 against 1 rank x 8, unfused, with the
    fused loss (K8/K9), with ``remat=True`` and with ``deep=mid="kernel"``,
    each at ``PACKED_DP_GATE`` (relative loss, lowest gradient cosine,
    largest norm change, running statistics), the one-ulp floor printed
    and two planted faults refused (K6's sums and K8's statistics left
    unreduced); both ranks' parameters and buffers equal; launches a rank
    a step (K4 6, K5 3, K6 36; K8 1 and K9 1 fused; 34 / 17 / 36
    ``"kernel"``); a step's time and peak memory a rank (two ranks share
    the card: no multi-card speed); ``cli train --packed`` for one epoch
    inside the two ranks (their ``local_mesh``): equal state, launches a
    rank, one checkpoint written by rank 0, which ``eval --checkpoint``
    reads.

The last lines are the card's name and power limit, a JSON object with the
kernels, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

F, NC, HW = 32, 10, 512
SEED = 0
TRAIN_BATCH = 8
# H100 SXM published dense peaks and HBM rate (NVIDIA data sheet)
PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}
HBM = 3.35e12

# TPU kernels each port kernel replaces (JAX package, file:line of the def)
_JAX = "retinal_oct_image_segmentation_via_deep_learning_tpu/ops/"
REPLACES = {
    "conv3x3_int8": [_JAX + "pallas_conv_psrp.py:442 conv3x3_psrp",
                     _JAX + "pallas_conv_psrp.py:777 stem_psrp",
                     _JAX + "pallas_conv_int8.py:204 conv3x3_int8",
                     _JAX + "pallas_conv_packed.py:213 conv3x3_int8_packed",
                     _JAX + "pallas_conv_packed.py:338 stem_conv3x3_int8_packed"],
    "ct2x2_int8": [_JAX + "pallas_conv_int8.py:323 ct2x2_int8",
                   _JAX + "pallas_conv_psrp.py:603 ct_up_psrp",
                   _JAX + "pallas_conv_psrp.py:676 ct_psrp"],
    "head_argmax": [_JAX + "pallas_conv_psrp.py:1074 head_argmax_psrp",
                    _JAX + "pallas_conv_packed.py:420 head_argmax_packed"],
    "conv3x3_bf16": [_JAX + "pallas_conv_bf16.py:121 _conv_fwd_pallas"],
    "conv3x3_bf16_wgrad": [_JAX + "pallas_conv_bf16.py:220 _conv_wgrad_pallas"],
    "bn_pair_sums": [_JAX + "fused_bn.py:66 _pallas_pair_sums"],
    "conv7x3_int8": [_JAX + "pallas_conv_psrp7.py:197 conv7x3_psrp",
                     _JAX + "pallas_conv_psrp7.py:360 stem7_psrp"],
    "dice_ce_stats": [_JAX + "pallas_loss.py:141 _run_fwd"],
    "dice_ce_bwd": [_JAX + "pallas_loss.py:187 _bwd"],
    "stem_conv_int8": [_JAX + "pallas_conv_psrp.py:964 stem_conv_psrp"],
    "pool2x2_int8": [_JAX + "pallas_conv_int8.py:377 pool2x2_int8"],
    "column_softargmax": [_JAX + "pallas_kernels.py:54 fused_column_softargmax"],
}
_PKG = "retinal_oct_image_segmentation_via_deep_learning_tpu_torch/"
SOURCES = {"conv3x3_int8": _PKG + "csrc/conv3x3_int8.cu",
           "ct2x2_int8": _PKG + "csrc/ct2x2_int8.cu",
           "head_argmax": _PKG + "csrc/head_argmax.cu",
           "conv3x3_bf16": _PKG + "csrc/conv3x3_bf16.cu",
           "conv3x3_bf16_wgrad": _PKG + "csrc/conv3x3_bf16.cu",
           "bn_pair_sums": _PKG + "csrc/bn_pair_sums.cu",
           "conv7x3_int8": _PKG + "csrc/conv7x3_int8.cu",
           "dice_ce_stats": _PKG + "csrc/dice_ce.cu",
           "dice_ce_bwd": _PKG + "csrc/dice_ce.cu",
           "stem_conv_int8": _PKG + "csrc/stem_conv_int8.cu",
           "pool2x2_int8": _PKG + "csrc/pool2x2_int8.cu",
           "column_softargmax": _PKG + "csrc/column_softargmax.cu"}
# kernel step vs plain-version step from the trained state: relative loss,
# lowest gradient cosine and largest change of a gradient's norm, each
# between the kernels' own floor (a one-ulp input change) and two planted
# kernel faults (PERF.md section 6)
GATE = {"loss": 1e-5, "cosine": 0.9999, "norm": 3e-3}
# the fused-loss step vs the unfused step from the trained state: the same
# three readings, each near the geometric middle of the one-ulp floor and
# the nearest of two planted K8/K9 faults (PERF.md section 6)
FUSED_GATE = {"loss": 1e-5, "cosine": 0.9997, "norm": 2e-3}
# the SDNet step from the trained state on the segmentation half of the
# loss (phase 24): K12, and every kernel, against the plain versions;
# relative loss and whole-gradient cosine, between the floor (the plain
# versions' float32 rounding) and a planted K6 fault (PERF.md section 6)
SDNET_GATE = {"loss": 1e-5, "cosine": 0.9999}
RELAYNET_F = 64
RELAYNET_GAIN = 0.75  # the 7x3 weights' scale in phase 13 (see there)
RELAYNET_LAUNCHES = {"conv7x3_int8": 7, "head_argmax": 1}
LAUNCHES_PER_FORWARD = {"conv3x3_int8": 18, "ct2x2_int8": 4,
                        "head_argmax": 1}
FUSED_STEM_LAUNCHES = {"stem_conv_int8": 1, "conv3x3_int8": 16,
                       "ct2x2_int8": 4, "head_argmax": 1}
INFER_BATCH = 4  # B-scans per cli infer run (phase 19)
SDNET_NC = 4  # the JAX SDNet's n_classes (its full-width defaults)
SDNET_BATCH = 8  # the SDNet forward (phases 23, 25)
SDNET_TRAIN_BATCH = 4  # the SDNet train step (phases 24, 25)
# K6 launches per SDNet train step: 43 BatchNorms, the modality encoder's 5
# of them run twice (on the image and on the reconstruction), each once in
# the forward and once in the backward
SDNET_K6_PER_STEP = 2 * (43 + 5)
LAUNCHES_PER_STEP = {
    "torch": {"conv3x3_bf16": 6, "conv3x3_bf16_wgrad": 3, "bn_pair_sums": 36},
    "kernel": {"conv3x3_bf16": 34, "conv3x3_bf16_wgrad": 17,
               "bn_pair_sums": 36},
}


def stages(f=F, hw=HW):
    """Every kernel call of one forward: (name, kernel, shape args).
    conv: (H, cins, cout, pool); ct: (H_in, cin, cout); head: (H, cin)."""
    out = [("stem blk0_conv0", "conv3x3_int8", (hw, (1,), f, False)),
           ("blk0_conv1", "conv3x3_int8", (hw, (f,), f, True))]
    h, c = hw // 2, f
    for i in range(1, 4):  # blk1..blk3
        out += [(f"blk{i}_conv0", "conv3x3_int8", (h, (c,), 2 * c, False)),
                (f"blk{i}_conv1", "conv3x3_int8", (h, (2 * c,), 2 * c, True))]
        h, c = h // 2, 2 * c
    out += [("blk4_conv0", "conv3x3_int8", (h, (c,), 2 * c, False)),
            ("blk4_conv1", "conv3x3_int8", (h, (2 * c,), 2 * c, False))]
    c *= 2
    for k, blk in enumerate((5, 6, 7, 8)):
        out.append((f"ct{k}", "ct2x2_int8", (h, c, c // 2)))
        h, c = 2 * h, c // 2
        out += [(f"blk{blk}_conv0", "conv3x3_int8", (h, (c, c), c, False)),
                (f"blk{blk}_conv1", "conv3x3_int8", (h, (c,), c, False))]
    out.append(("head", "head_argmax", (h, c)))
    return out


def train_convs():
    """The 17 non-stem 3x3 convs of the U-Net: (name, H, cin, cout, setting
    that puts them on K4: "always" | "mid" | "deep")."""
    f, hw = F, HW
    out = [("blk0_conv1", hw, f, f, "always")]
    h, c = hw // 2, f
    for i in range(1, 5):
        group = "mid" if i == 1 else "deep"
        out += [(f"blk{i}_conv0", h, c, 2 * c, group),
                (f"blk{i}_conv1", h, 2 * c, 2 * c, group)]
        h, c = h // 2, 2 * c
    for blk, h, c, group in ((5, hw // 8, 8 * f, "deep"),
                             (6, hw // 4, 4 * f, "deep"),
                             (7, hw // 2, 2 * f, "mid"),
                             (8, hw, f, "always")):
        out += [(f"blk{blk}_conv0", h, 2 * c, c, group),
                (f"blk{blk}_conv1", h, c, c, group)]
    return out


def tpu_row(name, kernel, shape):
    """The TPU kernel (ROADMAP Queue B id) that ran a serving stage in the
    JAX graph: PSRP kernels at 512^2 and 256^2, NHWC int8 ones below."""
    if kernel == "head_argmax":
        return "B7"
    if kernel == "ct2x2_int8":
        return {"ct2": "B5", "ct3": "B6"}.get(name, "B4")
    if name.startswith("stem"):
        return "B2"
    return "B1" if shape[0] >= 256 else "B3"


def bn_shapes():
    """(H, C) of the 18 BatchNorms: the stem's and each conv's."""
    return [(HW, F)] + [(h, cout) for _, h, _, cout, _ in train_convs()]


def bound(ops, nbytes, peak):
    """(least time in ms, "operations" or "bytes") for ``ops`` at ``peak``
    op/s and ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def serving_work(kernel, shape, n):
    """(int8 ops, bytes) of one serving-stage call at batch n: each input
    read once, each output written once."""
    if kernel == "conv3x3_int8":
        h, cins, cout, pool = shape
        cin = sum(cins)
        out = n * h * h * cout * (1.25 if pool else 1)
        return (2 * n * h * h * 9 * cin * cout,
                n * h * h * cin + 9 * cin * cout + 8 * cout + out)
    if kernel == "ct2x2_int8":
        h, cin, cout = shape
        return (2 * n * h * h * cin * cout * 4,
                n * h * h * cin + 4 * cin * cout + 8 * cout
                + n * 4 * h * h * cout)
    h, cin = shape
    return (2 * n * h * h * cin * NC,
            n * h * h * cin + cin * NC + 8 * NC + n * h * h)


def relaynet_stages(f, hw):
    """ReLayNet's K7 calls of one forward: (name, H, cins, pool)."""
    return [("b0 stem", hw, (1,), True), ("b1", hw // 2, (f,), True),
            ("b2", hw // 4, (f,), True), ("b3", hw // 8, (f,), False),
            ("b4", hw // 4, (f, f), False), ("b5", hw // 2, (f, f), False),
            ("b6", hw, (f, f), False)]


def relaynet_work(h, cins, pool, n, f=64):
    """(int8 ops, bytes) of one K7 call at batch n: each input read once,
    each output (with the pool: the pooled values and the indices too)
    written once."""
    cin = sum(cins)
    return (2 * n * h * h * 21 * cin * f,
            n * h * h * cin + 21 * cin * f + 8 * f
            + n * h * h * f * (1.5 if pool else 1))


T_START = time.perf_counter()


def train_batch(dev, n, seed, nc=NC, hw=None):
    """Seeded synthetic Duke-DME-shaped B-scans (z-scored) and labels of
    ``nc`` classes, ``hw`` (default ``HW``) square."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.data import (
        SyntheticOCTConfig,
        synth_batch,
    )

    gb = torch.Generator(device=dev).manual_seed(seed)
    hw = hw or HW
    images, labels = synth_batch(gb, n, SyntheticOCTConfig(
        height=hw, width=hw, num_layers=nc - 2))
    return preprocess(images), labels


def seeded_unet(dev, f=None, nc=None):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
        get_model,
    )

    return get_model("unet", num_classes=nc or NC, init_features=f or F,
                     seed=SEED).to(dev)


def train_cli_args():
    """``cli train --packed`` at f=F, NC classes, HW^2, TRAIN_BATCH, Adam
    1e-3, five one-step epochs."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli

    return cli.parser().parse_args([
        "train", "--packed", "--image-size", str(HW), "--num-classes",
        str(NC), "--batch-size", str(TRAIN_BATCH), "--num-train",
        str(TRAIN_BATCH), "--num-val", str(TRAIN_BATCH), "--epochs", "5",
        "--lr", "1e-3", "--optimizer", "adam", "--device", "cuda",
        "--model-kwargs", json.dumps({"init_features": F})])


def one_ulp_change(x, dev):
    """``x`` in bf16 with one ulp added to 1e-4 of its elements (seeded):
    how far a step moves under a rounding-sized change of its input."""
    import torch

    gp = torch.Generator(device=dev).manual_seed(SEED + 40)
    xi = x.to(torch.bfloat16).view(torch.int16)
    hit = torch.rand(xi.shape, generator=gp, device=dev) < 1e-4
    return torch.where(hit, xi + 1, xi).view(torch.bfloat16)


def agreement(a, b):
    """Of two (loss, {name: gradient}) results: (relative loss difference,
    (lowest gradient cosine, its tensor), (largest |norm ratio - 1|, its
    tensor)), over the tensors above a norm of 1e-3."""
    cos, ratio = (1.0, ""), (0.0, "")
    for n in a[1]:
        u, v = a[1][n].flatten(), b[1][n].flatten()
        nu, nv = float(u.norm()), float(v.norm())
        if max(nu, nv) > 1e-3:
            cos = min(cos, (float(u @ v) / (nu * nv), n))
            ratio = max(ratio, (abs(nu / nv - 1), n))
    return abs(a[0] - b[0]) / abs(b[0]), cos, ratio


def bf16_ulp(t):
    """bf16 ulp of each element's magnitude (float32)."""
    import torch

    t = torch.clamp_min(t.float().abs(), 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(t)) - 7)


def gate_passes(agree, gate):
    """A gate set between the one-ulp floor and planted faults (PERF.md
    section 6)."""
    return agree[0] < gate["loss"] and agree[1][0] > gate["cosine"] \
        and agree[2][0] < gate["norm"]


def reading(agree):
    return (f"relative loss {agree[0]:.2e}, lowest cosine "
            f"{agree[1][0]:.6f} ({agree[1][1]}), largest norm change "
            f"{agree[2][0]:.2e} ({agree[2][1]})")


PORT = "port: "
ENGINE = "autograd::engine::evaluate_function: "


def labelled(fn, label):
    """``fn`` inside ``torch.profiler.record_function("port: " + label)``,
    for ``profile_breakdown``'s split by port function."""
    import functools

    from torch.profiler import record_function

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with record_function(PORT + label):
            return fn(*args, **kwargs)

    return run


def split_by_function(prof, runs, skip):
    """Device ms a call of the kernels whose names hold none of ``skip``,
    by the port function that launched them (``labelled``): in the forward
    the innermost ``port:`` range around the op, in the backward the range
    around the forward op that made the autograd node (its sequence
    number). -> {label: (ms, {op: ms})}."""
    from torch.autograd import DeviceType

    def port(e):
        while e is not None:
            if e.name.startswith(PORT):
                return e.name[len(PORT):]
            e = e.cpu_parent
        return None

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    of_seq = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(ENGINE):
            label = port(e)
            if label is not None:
                of_seq.setdefault(e.sequence_nr, label)
    out = {}
    for e in cpu:
        if not e.kernels:
            continue
        label = port(e)
        if label is None:
            node = e
            while node is not None and not node.name.startswith(ENGINE):
                node = node.cpu_parent
            if node is None:
                label = "unlabelled"
            elif node.sequence_nr in of_seq:
                label = of_seq[node.sequence_nr] + " [backward]"
            else:
                label = node.name[len(ENGINE):] + " [backward]"
        for k in e.kernels:
            if any(key in k.name for key in skip):
                continue
            total, ops = out.setdefault(label, [0.0, {}])
            out[label][0] = total + k.duration / runs / 1e3
            ops[e.name] = ops.get(e.name, 0.0) + k.duration / runs / 1e3
    return out


def profile_breakdown(fn, runs, what, groups, split=False, host=False):
    """``torch.profiler`` over ``runs`` calls of ``fn``: wall and device
    busy time per call, device time and kernel launches by kernel group
    (name substring) and the 15 largest kernels; with ``split``, the
    device time outside the groups by port function
    (``split_by_function``); with ``host``, the host side
    (``host_breakdown``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device side of record_function ranges (``labelled``'s, the
    # optimizer's step) are annotations, not kernels
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith(PORT)
            and not getattr(e, "is_user_annotation", False)]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    total = sum(dev_us(e) for e in kern) / 1e3
    if total <= 0:
        print("profiler: no device time recorded (not measured)")
        return
    def in_group(e, keys):
        return any(k in e.key for k in ((keys,) if isinstance(keys, str)
                                        else keys))

    by_group = {gname: sum(dev_us(e) for e in kern if in_group(e, keys)) / 1e3
                for gname, keys in groups.items()}
    calls = {gname: sum(e.count for e in kern if in_group(e, keys)) / runs
             for gname, keys in groups.items()}
    by_group["everything else"] = total - sum(by_group.values())
    print(f"profile, {runs} x {what}: wall {wall_ms / runs:.3f} ms each, "
          f"device busy {total / runs:.3f} ms ({100 * total / wall_ms:.2f}%), "
          f"idle {100 * (1 - total / wall_ms):.2f}%")
    for gname, t in by_group.items():
        n = f", {calls[gname]:g} kernels a call" if gname in calls else ""
        print(f"  {gname:24s} {t / runs:8.3f} ms {100 * t / total:6.2f}%{n}")
    if split:
        skip = [k for keys in groups.values()
                for k in ((keys,) if isinstance(keys, str) else keys)]
        parts = split_by_function(prof, runs, skip)
        print(f"  everything else by port function (device ms a call; "
              f"{sum(v[0] for v in parts.values()):.3f} ms recorded):")
        for label, (t, ops) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
            top = ", ".join(f"{op} {v:.3f}" for op, v in
                            sorted(ops.items(), key=lambda kv: -kv[1])[:3])
            print(f"    {t:8.3f} ms  {label} ({top})")
    for e in sorted(kern, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / runs / 1e3:8.3f} ms "
              f"{100 * dev_us(e) / 1e3 / total:6.2f}%  {e.key[:100]}")
    if host:
        host_breakdown(prof, runs)


def host_breakdown(prof, runs):
    """The host side of a profile, a call: the operators and CUDA runtime
    calls recorded and their self CPU time, the kernel launches, the time
    spent waiting on the device, and the 10 largest by self CPU time."""
    from torch.autograd import DeviceType

    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
          and not getattr(e, "is_user_annotation", False)]
    waits = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
             "cudaEventSynchronize")
    runtime = [e for e in ev if e.key.startswith("cuda")]
    launch = [e for e in runtime if "LaunchKernel" in e.key]
    wait = [e for e in runtime if e.key in waits]

    def per_call(es):
        return (sum(e.count for e in es) / runs,
                sum(e.self_cpu_time_total for e in es) / runs / 1e3)

    n_all, t_all = per_call(ev)
    n_rt, t_rt = per_call(runtime)
    n_launch, t_launch = per_call(launch)
    _, t_wait = per_call(wait)
    print(f"  host, a call: {n_all:g} events, self CPU {t_all:.3f} ms; "
          f"of it CUDA runtime {n_rt:g} calls {t_rt:.3f} ms (kernel "
          f"launches {n_launch:g}, {t_launch:.3f} ms; waiting on the "
          f"device {t_wait:.3f} ms), operators and autograd "
          f"{n_all - n_rt:g} events {t_all - t_rt:.3f} ms")
    for e in sorted(ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        print(f"    {e.self_cpu_time_total / runs / 1e3:8.3f} ms self CPU, "
              f"{e.count / runs:g} a call  {e.key[:90]}")


def http_post(url, arr):
    """POST one array to the server's /predict; -> the returned array."""
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def k6_emulation():
    """``emulate`` of ``tests/test_torch_k6_order.py``: K6's order of
    additions in numpy float32 (that module imports JAX only inside the
    test that compares with it)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tests" / \
        "test_torch_k6_order.py"
    spec = importlib.util.spec_from_file_location("k6_order", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.emulate


def phase(name):
    print(f"\n=== {name} === (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


@contextlib.contextmanager
def swapped(module, **repl):
    """Put ``repl``'s functions in place of ``module``'s entry points of the
    same names (the op modules look their wrappers up by name at call
    time)."""
    saved = {k: getattr(module, k) for k in repl}
    for k, v in repl.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def train_phases(dev, card, time_ms):
    """Phases 6-8: the training path. -> the K4-K6 entries of the kernels
    line, and phase 7's trained state dict (on the host)."""
    import torch
    import torch.nn.functional as tnf

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
        OptimConfig,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_bf16 as k45,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        packed_unet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
        dice_ce_loss,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
        TrainState,
        create_train_state,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        make_train_step,
    )

    bf16 = torch.bfloat16
    names = ("conv3x3_bf16", "conv3x3_bf16_wgrad", "bn_pair_sums")
    k6_plans = {}

    def wrappers():
        return {"conv3x3_bf16": k45.conv3x3_bf16_fwd,
                "conv3x3_bf16_wgrad": k45.conv3x3_bf16_wgrad,
                "bn_pair_sums": k6.pair_sums}

    def reset():
        for w in wrappers().values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers().items()}

    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def ints(shape):
        return torch.randint(-2, 3, shape, generator=g, device=dev).to(bf16)

    def normal(shape, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) + mean).to(bf16)

    def batch(n, seed):
        return train_batch(dev, n, seed)

    def unet():
        return seeded_unet(dev)

    # ------------------------------------------------------------------ 6
    phase(f"6 training kernels vs plain versions (batch {TRAIN_BATCH})")
    max_err = {k: 0.0 for k in names}
    bad = 0
    nb = TRAIN_BATCH
    for name, h, cin, cout, group in train_convs():
        x, w, dy = ints((nb, h, h, cin)), ints((3, 3, cin, cout)), \
            ints((nb, h, h, cout))
        got = (k45.conv3x3_bf16_fwd(x, w),
               k45.conv3x3_bf16_fwd(dy, k45.flip_w(w)),
               k45.conv3x3_bf16_wgrad(x, dy))
        want = (k45.conv3x3_bf16_reference(x, w),
                k45.conv3x3_bf16_dgrad_reference(dy, w),
                k45.conv3x3_bf16_wgrad_reference(x, dy))
        torch.cuda.synchronize()
        mism = [int((a != b).sum()) for a, b in zip(got, want)]
        for k, a, b in zip(("conv3x3_bf16", "conv3x3_bf16",
                            "conv3x3_bf16_wgrad"), got, want):
            max_err[k] = max(max_err[k],
                             float((a.float() - b.float()).abs().max()))
        bodies = (k45.fwd_plan(nb, h, h, cin, cout).body,
                  k45.fwd_plan(nb, h, h, cout, cin).body)
        print(f"{name:11s} {h:4d}^2 {cin:4d}->{cout:4d} ({group:6s}) "
              f"mismatches fwd {mism[0]} dgrad {mism[1]} wgrad {mism[2]} "
              f"(K4 bodies fwd {bodies[0]}, dgrad {bodies[1]})", flush=True)
        bad += sum(mism)
        del x, w, dy, got, want
    worst_rel, repeats = 0.0, 0
    for h, c in bn_shapes():
        for two in (False, True):
            a = normal((nb, h, h, c), 1.0)
            b = normal((nb, h, h, c), 1.0) if two else None
            got, again = k6.pair_sums(a, b), k6.pair_sums(a, b)
            want = k6.pair_sums_reference(a, b)
            torch.cuda.synchronize()
            err = (got - want).abs()
            rel = float((err / want.abs()).max())
            max_err["bn_pair_sums"] = max(max_err["bn_pair_sums"],
                                          float(err.max()))
            worst_rel = max(worst_rel, rel)
            repeats += torch.equal(got, again)
            k6_plans[f"{h}^2x{c} {'bwd' if two else 'fwd'}"] = \
                k6.launch_plan(a, b).text()
            if rel > 1e-6 or not torch.equal(got, again):
                print(f"K6 {h}^2 x {c} two={two}: relative error {rel:.3e}, "
                      f"a second call {'the same' if torch.equal(got, again) else 'DIFFERENT'}")
                bad += 1
    print(f"K6 at the 18 BN shapes, both modes: worst relative error "
          f"{worst_rel:.3e} (limit 1e-6), max abs {max_err['bn_pair_sums']:.3e}; "
          f"a second call on the same inputs bit-identical at {repeats} of 36")
    for key in ("512^2x32 fwd", "32^2x512 fwd"):
        print(f"K6 plan {key}: {k6_plans[key]}")
    # K6 bit for bit against the numpy emulation of its order of additions
    # (tests/test_torch_k6_order.py) on the plan it launched, batch 2
    emulate = k6_emulation()
    for h, c in ((HW, F), (HW // 16, 16 * F)):
        for two in (False, True):
            a = normal((2, h, h, c), 1.0)
            b = normal((2, h, h, c), 1.0) if two else None
            got = k6.pair_sums(a, b)
            plan = k6.launch_plan(a, b)
            want = emulate(a.float().cpu().numpy(),
                           None if b is None else b.float().cpu().numpy(),
                           plan)
            same = np.array_equal(got.cpu().numpy(), want)
            print(f"K6 (2, {h}, {h}, {c}) two={two} against its emulation: "
                  f"{'bit-equal' if same else 'DIFFERENT'} (plan {plan.text()})",
                  flush=True)
            bad += not same
    # K5 sums in a fixed order: two calls on the same random inputs at the
    # default step's three K5 shapes give the same bits. K4 at the step's
    # six calls on random data: within one bf16 ulp of the float64 plain
    # version plus 2^-16 of the sum of |products| (the fp32 sums run in
    # another order), and a second call bit-identical (no atomics)
    for name, h, cin, cout, group in train_convs():
        if group != "always":
            continue
        x, dy = normal((nb, h, h, cin)), normal((nb, h, h, cout))
        first, second = k45.conv3x3_bf16_wgrad(x, dy), \
            k45.conv3x3_bf16_wgrad(x, dy)
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        print(f"K5 {name} {h}^2 {cin}->{cout}, two calls on random inputs: "
              f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
        bad += not same
        del first, second
        w = normal((3, 3, cin, cout))
        for label, a, wk, plain in (
            ("fwd", x, w, k45.conv3x3_bf16_reference),
            ("dgrad", dy, k45.flip_w(w), k45.conv3x3_bf16_dgrad_reference),
        ):
            first, second = k45.conv3x3_bf16_fwd(a, wk), \
                k45.conv3x3_bf16_fwd(a, wk)
            want = plain(a, w).float()
            mag = plain(a.abs(), w.abs()).float()
            torch.cuda.synchronize()
            err = (first.float() - want).abs()
            over = int((err > bf16_ulp(want) + 2.0 ** -16 * mag).sum())
            same = torch.equal(first, second)
            print(f"K4 {label} {name} {h}^2 on random inputs "
                  f"({k45.fwd_plan(*a.shape, wk.shape[-1]).body}): max abs "
                  f"error {float(err.max()):.3e}, {over} elements beyond one "
                  f"ulp + 2^-16 of the sum of |products|; a second call "
                  f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
            bad += over + (not same)
            del first, second, want, mag, err
        del x, dy, w
    if bad:
        raise RuntimeError(f"{bad} training-kernel checks failed")
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 7
    phase(f"7 train: cli train --packed (f={F}, {NC} classes, {HW}x{HW}, "
          f"batch {TRAIN_BATCH}, Adam 1e-3), five steps")
    trainer, train_ds, val_ds = cli.build_training(train_cli_args())
    reset()
    t0 = time.perf_counter()
    trained = trainer.fit(train_ds, val_ds).model.state_dict()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = counts()
    losses = [r["train_loss"] for r in trainer.history]
    for r in trainer.history:
        print(f"epoch {r['epoch']} (one step): train_loss {r['train_loss']:.6f}"
              f" val_loss {r['val_loss']:.6f} time {r['time_s']:.3f} s")
    print(f"fit: {fit_s:.2f} s for 5 steps + 5 validations; launches "
          f"{launches}, expected 5 x {LAUNCHES_PER_STEP['torch']}", flush=True)
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train losses {losses}")
    if not losses[4] < losses[0]:
        raise RuntimeError(f"loss did not go down: {losses}")
    if any(launches[k] != 5 * v for k, v in LAUNCHES_PER_STEP["torch"].items()):
        raise RuntimeError("launch counts do not match the train step")
    del trainer, train_ds, val_ds
    torch.cuda.empty_cache()

    x8, y8 = batch(TRAIN_BATCH, SEED + 20)

    def loss_and_grads(weights, x=x8):
        model = unet()
        if weights is not None:
            model.load_state_dict(weights)
        logits, _ = packed_unet.packed_unet_apply(model, x)
        loss = dice_ce_loss(logits, y8)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.detach().double()
                                      for n, p in model.named_parameters()}

    def passes(agree):
        return gate_passes(agree, GATE)

    # beside each comparison, the same kernel step with one bf16 ulp added
    # to 1e-4 of the input pixels: how far the function itself moves under a
    # rounding-sized change. The gate is the trained state's: at the random
    # init the deep layers' bf16 gradients move that much under such a change
    x_ulp = one_ulp_change(x8, dev)
    for label, weights in (("the random init", None),
                           ("the trained state", trained)):
        kern = loss_and_grads(weights)
        with swapped(k45, conv3x3_bf16_fwd=k45.conv3x3_bf16_reference,
                     conv3x3_bf16_wgrad=k45.conv3x3_bf16_wgrad_reference), \
                swapped(k6, pair_sums=k6.pair_sums_reference):
            agree = agreement(kern, loss_and_grads(weights))
        floor = agreement(kern, loss_and_grads(weights, x_ulp))
        print(f"one step from {label}, kernels vs plain versions: "
              f"{reading(agree)}; kernels on a 1-ulp input change: "
              f"{reading(floor)}", flush=True)

    # planted faults, each a wrong kernel the gate must reject
    fwd, wgrad, sums = k45.conv3x3_bf16_fwd, k45.conv3x3_bf16_wgrad, \
        k6.pair_sums

    def k4_drops_tiles(x, w):
        """K4 with every 64th tile x channel tile (its unit of work, from
        ``fwd_plan``) left out (zero), counted from the centre of the first
        image (the retina; the top rows are background)."""
        n, h, wd, _ = x.shape
        cout = w.shape[-1]
        plan = k45.fwd_plan(n, h, wd, x.shape[-1], cout)
        keep = torch.ones(plan.units, dtype=x.dtype, device=x.device)
        keep[((plan.tiles_y // 2) * plan.tiles_x + plan.tiles_x // 2)
             * plan.n_co % 64::64] = 0
        keep = keep.view(n, plan.tiles_y, plan.tiles_x, plan.n_co)
        mask = keep.repeat_interleave(plan.rows, 1)[:, :h] \
            .repeat_interleave(plan.cols, 2)[:, :, :wd] \
            .repeat_interleave(plan.co_t, 3)[..., :cout]
        return fwd(x, w) * mask

    def k5_drops_tiles(x, dy):
        """K5 with every 64th band x column tile (its unit of work, from
        ``wgrad_plan``) left out, counted from the centre of the first image
        (the retina; the top band is background)."""
        n, h, w, cout = dy.shape
        plan = k45.wgrad_plan(n, h, w, x.shape[-1], cout)
        keep = torch.ones(plan.units, dtype=dy.dtype, device=dy.device)
        keep[(plan.nbands // 2 * plan.nct + plan.nct // 2) % 64::64] = 0
        keep = keep.view(n, plan.nbands, plan.nct)
        mask = keep.repeat_interleave(plan.R, 1)[:, :h] \
            .repeat_interleave(plan.twk, 2)
        return wgrad(x, (dy * mask[:, :, :w, None]).contiguous())

    def k6_sums_high(a, b=None):
        """K6 with its sums 0.5% high."""
        return sums(a, b) * 1.005

    def k6_drops_block(a, b=None):
        """K6 with the rows of one block of its plan (its unit of work, from
        ``launch_plan``) left out: the block that holds the centre pixel of
        the first image (the retina)."""
        n, h, w, c = a.shape
        plan = k6.launch_plan(a.contiguous(),
                              None if b is None else b.contiguous())
        rows = plan.rows(((h // 2) * w + w // 2) // plan.rows_block)
        kept = a.reshape(-1, c).clone()
        kept[rows.start:rows.stop] = 0
        return sums(kept.view(a.shape), b)

    # the real wrappers count their launches under their module names,
    # which point at the faults while these run
    k4_drops_tiles.launches = k5_drops_tiles.launches = 0
    k6_sums_high.launches = k6_drops_block.launches = 0
    faults = {}
    for label, fault in (
        ("K4 leaves out 1/64 of its tiles",
         swapped(k45, conv3x3_bf16_fwd=k4_drops_tiles)),
        ("K5 leaves out 1/64 of its bands",
         swapped(k45, conv3x3_bf16_wgrad=k5_drops_tiles)),
        ("K6 sums 0.5% high", swapped(k6, pair_sums=k6_sums_high)),
        ("K6 leaves out the rows of one block",
         swapped(k6, pair_sums=k6_drops_block)),
    ):
        with fault:
            faults[label] = agreement(kern, loss_and_grads(trained))
        print(f"planted fault, {label}: {reading(faults[label])}", flush=True)
    print(f"gate (the trained state): relative loss < {GATE['loss']}, "
          f"cosine > {GATE['cosine']}, norm change < {GATE['norm']}")
    if not passes(agree):
        raise RuntimeError("kernel step and plain step disagree")
    seen = [label for label, a in faults.items() if not passes(a)]
    if len(seen) != len(faults):
        raise RuntimeError(f"the gate sees only the faults {seen}")
    for setting, want in LAUNCHES_PER_STEP.items():
        state = create_train_state(unet(), OptimConfig())
        step = packed_unet.make_packed_train_step(dice_ce_loss, deep=setting,
                                                  mid=setting)
        reset()
        step(state, x8, y8)
        torch.cuda.synchronize()
        got = counts()
        print(f"launches per step, mid=deep={setting!r}: {got}")
        if got != want:
            raise RuntimeError(f"expected {want}")
    del state, step
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 8
    phase(f"8 training times on {card}")
    nb = TRAIN_BATCH
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "operations": 0.0, "bytes": 0.0} for k in names}
    every17 = {k: [0.0, 0.0] for k in ("conv3x3_bf16", "conv3x3_bf16_wgrad")}
    # K5's own reading (device time over both of its passes, torch.profiler)
    k5 = {"ms": 0.0, "device": 0.0, "library": 0.0, "library_device": 0.0,
          "bound": 0.0, "bytes": 0.0, "device17": 0.0,
          "library_device17": 0.0}
    # K4's: device time per call beside event time, and the WMMA body at
    # the same calls (the default step's six; all 17 convs' fwd and dgrad)
    k4 = {"ms": 0.0, "device": 0.0, "library": 0.0, "library_device": 0.0,
          "bound": 0.0, "wmma": 0.0, "wmma_device": 0.0, "device17": 0.0,
          "wmma_device17": 0.0, "library_device17": 0.0}
    k4_plans = []

    def add(k, main, ms, pms, lms, work, peak):
        b_ms, b_by = bound(*work, peak)
        if main:
            for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                           (b_by, b_ms)):
                rows[k][key] += v
        return b_ms, b_by

    for name, h, cin, cout, group in train_convs():
        main = group == "always"  # on K4 in the default (main path) step
        x, dy = normal((nb, h, h, cin)), normal((nb, h, h, cout))
        w = normal((3, 3, cin, cout))
        wf = k45.flip_w(w)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        ops = 2 * nb * h * h * 9 * cin * cout
        act = 2 * nb * h * h * (cin + cout)
        runs = 10 if main else 3
        with torch.no_grad():
            for label, k, fn, plain, lib, nbytes in (
                ("fwd", "conv3x3_bf16",
                 lambda: k45.conv3x3_bf16_fwd(x, w),
                 lambda: k45.conv3x3_bf16_reference(x, w),
                 lambda: tnf.conv2d(xc, w_oihw, padding=1),
                 act + 2 * 9 * cin * cout),
                ("dgrad", "conv3x3_bf16",
                 lambda: k45.conv3x3_bf16_fwd(dy, wf),
                 lambda: k45.conv3x3_bf16_dgrad_reference(dy, w),
                 lambda: torch.nn.grad.conv2d_input(xc.shape, w_oihw, dyc,
                                                    padding=1),
                 act + 2 * 9 * cin * cout),
                ("wgrad", "conv3x3_bf16_wgrad",
                 lambda: k45.conv3x3_bf16_wgrad(x, dy),
                 lambda: k45.conv3x3_bf16_wgrad_reference(x, dy),
                 lambda: torch.nn.grad.conv2d_weight(xc, w_oihw.shape, dyc,
                                                     padding=1),
                 act + 4 * 9 * cin * cout),
            ):
                ms = time_ms(fn, runs)
                pms = time_ms(plain, 3)
                lms = time_ms(lib, runs)
                b_ms, b_by = add(k, main, ms, pms, lms, (ops, nbytes),
                                 PEAK["bf16"])
                every17[k][0] += ms
                every17[k][1] += lms
                print(f"time b{nb} {name:11s} {label:5s} kernel {ms:.4f} ms "
                      f"({ops / ms / 1e9:.1f} TFLOP/s), plain {pms:.4f}, "
                      f"library {lms:.4f}, bound {b_ms:.4f} ({b_by})"
                      f"{' [main path]' if main else ''}", flush=True)
                if label != "wgrad":
                    a, wk = (x, w) if label == "fwd" else (dy, wf)
                    plan = k45.fwd_plan(*a.shape, wk.shape[-1],
                                        a.data_ptr() % 16 == 0)
                    wmma = k45.plan_for(*a.shape, wk.shape[-1], "wmma")
                    dms, dlms = device_ms(fn), device_ms(lib)
                    wms = time_ms(lambda: k45._launch_fwd(a, wk, wmma), runs)
                    wdms = device_ms(lambda: k45._launch_fwd(a, wk, wmma))
                    for key, v in (("device17", dms), ("wmma_device17", wdms),
                                   ("library_device17", dlms)):
                        k4[key] += v
                    if main:
                        for key, v in (("ms", ms), ("device", dms),
                                       ("library", lms),
                                       ("library_device", dlms),
                                       ("bound", b_ms), ("wmma", wms),
                                       ("wmma_device", wdms)):
                            k4[key] += v
                        k4_plans.append({
                            "call": f"{label} {name}", "body": plan.body,
                            "tile": [plan.rows, plan.cols],
                            "co_t": plan.co_t, "stages": plan.stages,
                            "blocks_per_sm": plan.blocks_per_sm,
                            "smem": plan.smem})
                    print(f"time b{nb} {name:11s} {label:5s} K4 "
                          f"{'[WMMA body] ' if plan.body == 'wmma' else ''}"
                          f"device {dms:.4f} ms "
                          f"({ops / dms / 1e9:.1f} TFLOP/s, "
                          f"{nbytes / dms / 1e6:.0f} GB/s), event {ms:.4f}; "
                          f"the WMMA body device {wdms:.4f}, event {wms:.4f}; "
                          f"library device {dlms:.4f}; plan {plan}",
                          flush=True)
                    continue
                dms, dlms = device_ms(fn), device_ms(lib)
                k5["device17"] += dms
                k5["library_device17"] += dlms
                if main:
                    for key, v in (("ms", ms), ("device", dms),
                                   ("library", lms), ("library_device", dlms),
                                   ("bound", b_ms), ("bytes", nbytes)):
                        k5[key] += v
                print(f"time b{nb} {name:11s} K5 device {dms:.4f} ms "
                      f"({ops / dms / 1e9:.1f} TFLOP/s, "
                      f"{nbytes / dms / 1e6:.0f} GB/s of {nbytes / 1e6:.1f} "
                      f"MB), conv2d_weight device {dlms:.4f} ms, plan "
                      f"{k45.wgrad_plan(nb, h, h, cin, cout)}", flush=True)
        del x, dy, w, wf, w_oihw, xc, dyc
        torch.cuda.empty_cache()
    for k, (ms, lms) in every17.items():
        print(f"time b{nb} {k} over all 17 convs (the mid=deep='kernel' "
              f"step): kernel {ms:.4f} ms, library {lms:.4f} ms")
    print(f"time b{nb} K4 summed over the default step's six calls: event "
          f"{k4['ms']:.4f} ms, device {k4['device']:.4f} ms; library "
          f"(F.conv2d + conv2d_input) event {k4['library']:.4f}, device "
          f"{k4['library_device']:.4f}; the WMMA body event {k4['wmma']:.4f}, "
          f"device {k4['wmma_device']:.4f}; bound {k4['bound']:.4f} ms; "
          f"event time {k4['ms'] / k4['library']:.3f}x the library's, "
          f"device time at {100 * k4['bound'] / k4['device']:.1f}% of the "
          f"bound's rate", flush=True)
    print(f"time b{nb} K4 over all 17 convs (fwd and dgrad), device: the "
          f"planned bodies {k4['device17']:.4f} ms, the WMMA body "
          f"{k4['wmma_device17']:.4f} ms, the library "
          f"{k4['library_device17']:.4f} ms")
    print(f"time b{nb} K5 over all 17 convs, device: kernel "
          f"{k5['device17']:.4f} ms, conv2d_weight {k5['library_device17']:.4f}"
          f" ms")
    print(f"time b{nb} K5 summed over the default step's three calls: device "
          f"{k5['device']:.4f} ms (event {k5['ms']:.4f}), conv2d_weight device "
          f"{k5['library_device']:.4f} ms (event {k5['library']:.4f}), bound "
          f"{k5['bound']:.4f} ms (bytes: {k5['bytes'] / 1e6:.1f} MB), achieved "
          f"{k5['bytes'] / k5['device'] / 1e6:.0f} GB/s of {HBM / 1e9:.0f}",
          flush=True)
    dims = (0, 1, 2)
    # K6's device time (torch.profiler) per call beside its event time
    k6_dev = {"fwd": 0.0, "bwd": 0.0, "fwd library": 0.0, "bwd library": 0.0}
    for h, c in bn_shapes():
        a, b = normal((nb, h, h, c), 1.0), normal((nb, h, h, c), 1.0)
        m = nb * h * h
        a2, b2 = a.reshape(m, c), b.reshape(m, c)
        for label, args, lib, nbytes in (
            ("fwd", (a,), lambda: torch.var_mean(a, dim=dims, correction=0),
             2 * m * c + 8 * c),
            ("bwd", (a, b), lambda: torch.linalg.vecdot(a2, b2, dim=0),
             4 * m * c + 8 * c),
        ):
            ms = time_ms(lambda: k6.pair_sums(*args))
            pms = time_ms(lambda: k6.pair_sums_reference(*args), 3)
            lms = time_ms(lib)
            dms, dlms = device_ms(lambda: k6.pair_sums(*args)), device_ms(lib)
            k6_dev[label] += dms
            k6_dev[label + " library"] += dlms
            b_ms, b_by = add("bn_pair_sums", True, ms, pms, lms,
                             (3 * m * c, nbytes), PEAK["fp32"])
            print(f"time b{nb} K6 {h:4d}^2 x {c:4d} {label}: kernel device "
                  f"{dms:.4f} ms ({nbytes / dms / 1e6:.0f} GB/s, "
                  f"{100 * b_ms / dms:.1f}% of the bound's rate), event "
                  f"{ms:.4f}; library device {dlms:.4f}, event {lms:.4f}; "
                  f"plain {pms:.4f}; bound {b_ms:.4f} ({b_by})", flush=True)
        del a, b, a2, b2
    print(f"time b{nb} K6 summed over the default step's 36 calls, device: "
          f"kernel {k6_dev['fwd'] + k6_dev['bwd']:.4f} ms (fwd "
          f"{k6_dev['fwd']:.4f}, bwd {k6_dev['bwd']:.4f}), library "
          f"{k6_dev['fwd library'] + k6_dev['bwd library']:.4f} ms (fwd "
          f"{k6_dev['fwd library']:.4f}, bwd {k6_dev['bwd library']:.4f})",
          flush=True)
    for k, r in rows.items():
        print(f"time b{nb} {k} summed over the default step's calls: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound "
              f"{r['operations'] + r['bytes']:.4f}")
    torch.cuda.empty_cache()

    def step_for(setting, n):
        state = create_train_state(unet(), OptimConfig())
        if setting == "library":
            return state, make_train_step(dice_ce_loss)
        return state, packed_unet.make_packed_train_step(
            dice_ce_loss, deep=setting, mid=setting)

    for setting in ("torch", "kernel", "library"):
        for n in (TRAIN_BATCH, 2 * TRAIN_BATCH):
            xs, ys = batch(n, SEED + 30 + n)
            torch.cuda.reset_peak_memory_stats()
            state, step = step_for(setting, n)
            for _ in range(2):
                step(state, xs, ys)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                loss = step(state, xs, ys)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 5 * 1e3
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            what = ("packed, mid=deep=" + repr(setting) if setting != "library"
                    else "unpacked UNet, library convs, autocast bf16")
            print(f"train step ({what}) batch {n}: {ms:.3f} ms, "
                  f"{n / ms * 1e3:.1f} B-scans/s, peak memory {peak_gb:.2f} "
                  f"GB, loss {float(loss):.4f}", flush=True)
            del state, step, xs, ys, loss
            torch.cuda.empty_cache()

    # the default step, its "everything else" split by the port function
    # that launched it (record_function around each, in this script only)
    state = create_train_state(unet(), OptimConfig())
    step = packed_unet.make_packed_train_step(
        labelled(dice_ce_loss, "the loss (dice_ce_loss)"))
    for _ in range(2):
        step(state, x8, y8)
    convs = packed_unet._CONVS
    with swapped(packed_unet,
                 packed_unet_apply=labelled(
                     packed_unet.packed_unet_apply,
                     "the rest of the forward (skip concats, head, "
                     "running-stat updates)"),
                 bn_train=labelled(packed_unet.bn_train,
                                   "bn_train: normalize (dx in the backward)"),
                 _CONVS={"torch": labelled(convs["torch"],
                                           "library conv and its casts"),
                         "kernel": labelled(convs["kernel"],
                                            "K4 conv's casts and permutes")},
                 _pool=labelled(packed_unet._pool, "pool"),
                 _ct=labelled(packed_unet._ct,
                              "transposed conv (library) and bias"),
                 apply_batch_stats=labelled(packed_unet.apply_batch_stats,
                                            "running stats written")), \
            swapped(torch, relu=labelled(torch.relu, "relu")), \
            swapped(TrainState, apply_gradients=labelled(
                TrainState.apply_gradients, "Adam (apply_gradients)")):
        profile_breakdown(lambda: step(state, x8, y8), 3,
                          f"default steps at batch {TRAIN_BATCH}",
                          {"K4 conv3x3_bf16": ("conv3x3_bf16_fwd",
                                               "conv3x3_bf16_mma"),
                           "K5 conv3x3_bf16_wgrad": "conv3x3_bf16_wgrad",
                           "K6 bn_pair_sums": "pair_sums"}, split=True)
    del state, step

    out = [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": "; ".join(REPLACES[k]), "launches": launches[k],
        "max_abs_err": max_err[k], "ms": rows[k]["ms"],
        "plain_ms": rows[k]["plain_ms"],
        "bound_ms": rows[k]["operations"] + rows[k]["bytes"],
        "bound_by": ("operations" if rows[k]["operations"]
                     >= rows[k]["bytes"] else "bytes"),
        "library_ms": rows[k]["library_ms"],
    } for k in names]
    out[0].update(device_ms=k4["device"], plan=k4_plans)
    out[2].update(body="pair_sums_kernel (one cooperative launch a call)",
                  device_ms=k6_dev["fwd"] + k6_dev["bwd"], plan=k6_plans)
    return out, {k: v.cpu() for k, v in trained.items()}


def k9_within_ulp(dx, exact):
    """K9's dlogits against the float64 ones: (elements beyond one ulp of
    dx's dtype plus the fp32 floor of 2^-20 of the largest, largest error
    in ulps). The floor: dlogit is an fp32 sum of terms as large as the
    largest element, which can cancel."""
    import torch

    want = exact.to(dx.dtype).float().abs().clamp_min(2.0 ** -126)
    if dx.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(want)) - 7)
    else:
        ulp = want * 2.0 ** -23
    err = (dx.double() - exact).abs()
    floor = 2.0 ** -20 * float(exact.abs().max())
    return (int((err > ulp.double() + floor).sum()),
            float((err / ulp.double()).max()))


def fused_loss_phases(dev, card, time_ms):
    """Phases 9-11: the fused Dice+CE loss (K8, K9) on the packed train
    step. -> the K8 and K9 entries of the kernels line."""
    import os

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
        OptimConfig,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_bf16 as k45,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        dice_ce as k89,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        packed_unet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
        dice_ce_loss,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
        create_train_state,
    )

    names = ("dice_ce_stats", "dice_ce_bwd")
    every = {"conv3x3_bf16": k45.conv3x3_bf16_fwd,
             "conv3x3_bf16_wgrad": k45.conv3x3_bf16_wgrad,
             "bn_pair_sums": k6.pair_sums,
             "dice_ce_stats": k89.dice_ce_stats,
             "dice_ce_bwd": k89.dice_ce_bwd}

    def reset():
        for w in every.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in every.items()}

    def batch(n, seed):
        return train_batch(dev, n, seed)

    def unet():
        return seeded_unet(dev)

    nb, P = TRAIN_BATCH, TRAIN_BATCH * HW * HW
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    logits = (torch.randn((nb, HW, HW, NC), generator=g, device=dev)
              * 3).to(torch.bfloat16)
    labels = torch.randint(0, NC, (nb, HW, HW), generator=g, device=dev)
    weights = {"uniform": torch.ones(NC, device=dev),
               "class weights": torch.linspace(0.5, 2.0, NC, device=dev)}

    # ------------------------------------------------------------------ 9
    phase(f"9 fused-loss kernels vs plain versions ({nb}, {HW}, {HW}, {NC}) "
          "bf16 logits, int64 labels")
    max_err = {k: 0.0 for k in names}
    bad = 0
    for label, cw in weights.items():
        stats = k89.dice_ce_stats(logits, labels, cw)
        want = k89.dice_ce_stats_reference(logits, labels, cw)
        exact = k89.dice_ce_stats_reference(logits.double(), labels, cw)
        coef = k89.loss_coefficients(want, torch.ones((), device=dev), NC,
                                     1.0, label == "uniform", cw)
        dx = k89.dice_ce_bwd(logits, labels, coef)
        dx_exact = k89.dice_ce_bwd_reference(logits.double(), labels, coef)
        torch.cuda.synchronize()
        rel = float(((stats.double() - exact.double()).abs()
                     / exact.double().abs().clamp_min(1e-30)).max())
        beyond, ulps = k9_within_ulp(dx, dx_exact)
        max_err["dice_ce_stats"] = max(max_err["dice_ce_stats"],
                                       float((stats - want).abs().max()))
        max_err["dice_ce_bwd"] = max(
            max_err["dice_ce_bwd"],
            float((dx.float() - k89.dice_ce_bwd_reference(
                logits, labels, coef).float()).abs().max()))
        same = torch.equal(k89.dice_ce_stats(logits, labels, cw), stats)
        print(f"{label}: K8 largest relative error vs float64 {rel:.3e} "
              f"(limit 1e-5), a second call bit-identical {same}; K9 "
              f"elements beyond one bf16 ulp + floor {beyond} of "
              f"{dx.numel()}, largest error {ulps:.3f} ulp", flush=True)
        bad += (rel > 1e-5) + beyond + (not same)
    print(f"K8 plan: {k89.launch_stats_plan(logits, labels).text()}",
          flush=True)
    if bad:
        raise RuntimeError("fused-loss kernel checks failed")

    # ------------------------------------------------------------------ 10
    phase(f"10 train: cli train --packed with OCTSEG_PACKED_FUSED_LOSS=1 "
          f"(f={F}, {NC} classes, {HW}x{HW}, batch {nb}), five steps")
    os.environ["OCTSEG_PACKED_FUSED_LOSS"] = "1"
    try:
        trainer, train_ds, val_ds = cli.build_training(train_cli_args())
        reset()
        trained = trainer.fit(train_ds, val_ds).model.state_dict()
        torch.cuda.synchronize()
        launches = counts()
    finally:
        del os.environ["OCTSEG_PACKED_FUSED_LOSS"]
    losses = [r["train_loss"] for r in trainer.history]
    print(f"train losses {[f'{v:.6f}' for v in losses]}; launches "
          f"{launches}, expected 5 x K8/K9 1/1 and "
          f"{LAUNCHES_PER_STEP['torch']}", flush=True)
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train losses {losses}")
    if not losses[4] < losses[0]:
        raise RuntimeError(f"loss did not go down: {losses}")
    want = {**{k: 5 * v for k, v in LAUNCHES_PER_STEP["torch"].items()},
            "dice_ce_stats": 5, "dice_ce_bwd": 5}
    if launches != want:
        raise RuntimeError(f"launch counts, expected {want}")
    del trainer, train_ds, val_ds
    torch.cuda.empty_cache()

    x8, y8 = batch(nb, SEED + 20)

    def step_grads(fused, x=x8):
        model = unet()
        model.load_state_dict(trained)
        out, _ = packed_unet.packed_unet_apply(model, x)
        loss = (k89.dice_ce_loss_fused if fused else dice_ce_loss)(out, y8)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.detach().double()
                                      for n, p in model.named_parameters()}

    x_ulp = one_ulp_change(x8, dev)
    fused, unfused = step_grads(True), step_grads(False)
    agree = agreement(fused, unfused)
    floor = agreement(fused, step_grads(True, x_ulp))
    print(f"one step from the trained state, fused vs unfused loss: "
          f"{reading(agree)}; fused on a 1-ulp input change: "
          f"{reading(floor)}", flush=True)
    stats_fn, bwd_fn = k89.dice_ce_stats, k89.dice_ce_bwd

    def k9_drops_pixels(x, lab, coef):
        """K9 with every 64th pixel's dlogits left out."""
        dx = bwd_fn(x, lab, coef)
        dx.view(-1, dx.shape[-1])[::64] = 0
        return dx

    def k8_counts_high(x, lab, cw):
        """K8 with its per-class label counts 0.5% high (scaling every sum
        alike would leave the loss's ratios, and so the loss, as they
        are)."""
        stats = stats_fn(x, lab, cw)
        stats[2 * NC:3 * NC] *= 1.005
        return stats

    k9_drops_pixels.launches = k8_counts_high.launches = 0
    faults = {}
    for label, fault in (
        ("K9 leaves out every 64th pixel",
         swapped(k89, dice_ce_bwd=k9_drops_pixels)),
        ("K8 counts 0.5% high",
         swapped(k89, dice_ce_stats=k8_counts_high)),
    ):
        with fault:
            faults[label] = agreement(step_grads(True), unfused)
        print(f"planted fault, {label}: {reading(faults[label])}", flush=True)
    print(f"gate: relative loss < {FUSED_GATE['loss']}, cosine > "
          f"{FUSED_GATE['cosine']}, norm change < {FUSED_GATE['norm']}")
    if not gate_passes(agree, FUSED_GATE):
        raise RuntimeError("fused-loss step and unfused step disagree")
    seen = [k for k, a in faults.items() if not gate_passes(a, FUSED_GATE)]
    if len(seen) != len(faults):
        raise RuntimeError(f"the gate sees only the faults {seen}")
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 11
    phase(f"11 fused-loss times on {card}")
    cw = weights["uniform"]
    stats = k89.dice_ce_stats(logits, labels, cw)
    coef = k89.loss_coefficients(stats, torch.ones((), device=dev), NC, 1.0,
                                 True, cw)
    lab_bytes = labels.element_size() * P
    work = {"dice_ce_stats": (8 * P * NC, 2 * P * NC + lab_bytes + 4 * NC
                              + 4 * (3 * NC + 2)),
            "dice_ce_bwd": (16 * P * NC, 4 * P * NC + lab_bytes
                            + 4 * 3 * NC)}
    rows = {}
    for k, fn, plain in (
        ("dice_ce_stats", lambda: k89.dice_ce_stats(logits, labels, cw),
         lambda: k89.dice_ce_stats_reference(logits, labels, cw)),
        ("dice_ce_bwd", lambda: k89.dice_ce_bwd(logits, labels, coef),
         lambda: k89.dice_ce_bwd_reference(logits, labels, coef)),
    ):
        ms, pms = time_ms(fn), time_ms(plain, 3)
        dms = device_ms(fn)
        b_ms, b_by = bound(*work[k], PEAK["fp32"])
        rows[k] = (ms, pms, b_ms, b_by, dms)
        gate = (" (must < 0.075, aim <= 0.045); plan "
                f"{k89.launch_plan(logits, labels)}" if k == "dice_ce_bwd"
                else " (must < 0.050, aim <= 0.028); plan "
                f"{k89.launch_stats_plan(logits, labels).text()}")
        print(f"time b{nb} {k}: kernel {ms:.4f} ms "
              f"({work[k][1] / ms / 1e6:.0f} GB/s), device {dms:.4f} ms "
              f"({work[k][1] / dms / 1e6:.0f} GB/s, {100 * b_ms / dms:.2f}% "
              f"of the bound's rate){gate}, plain {pms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)

    def fwd_bwd(fn):
        def run():
            x = logits.detach().requires_grad_()
            torch.autograd.grad(fn(x, labels), x)
        return run

    for label, fn in (("unfused dice_ce_loss", dice_ce_loss),
                      ("fused dice_ce_loss_fused", k89.dice_ce_loss_fused)):
        print(f"time b{nb} {label} forward + backward: "
              f"{time_ms(fwd_bwd(fn)):.4f} ms", flush=True)

    xs, ys = batch(nb, SEED + 30 + nb)

    def warm_step(fused):
        state = create_train_state(unet(), OptimConfig())
        step = packed_unet.make_packed_train_step(dice_ce_loss,
                                                  fused_loss=fused)
        for _ in range(2):
            step(state, xs, ys)
        return lambda: step(state, xs, ys)

    for fused in (False, True, True, False):
        step = warm_step(fused)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"train step (packed, {'fused' if fused else 'unfused'} loss) "
              f"batch {nb}: {ms:.3f} ms, {nb / ms * 1e3:.1f} B-scans/s",
              flush=True)
    profile_breakdown(warm_step(True), 3, f"fused-loss steps at batch {nb}",
                      {"K8 dice_ce_stats": "dice_ce_stats",
                       "K9 dice_ce_bwd": "dice_ce_bwd",
                       "K4 conv3x3_bf16": ("conv3x3_bf16_fwd",
                                           "conv3x3_bf16_mma"),
                       "K5 conv3x3_bf16_wgrad": "conv3x3_bf16_wgrad",
                       "K6 bn_pair_sums": "pair_sums"})
    del step, xs, ys
    torch.cuda.empty_cache()

    return [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": "; ".join(REPLACES[k]), "launches": launches[k],
        "max_abs_err": max_err[k], "ms": rows[k][0], "plain_ms": rows[k][1],
        "bound_ms": rows[k][2], "bound_by": rows[k][3],
        "device_ms": rows[k][4],
        # no single PyTorch call computes Dice + CE (the unfused loss's
        # time is printed above)
        "library_ms": None,
    } for k in names]


def relaynet_phases(dev, card, time_ms, http_post):
    """Phases 12-15: ReLayNet's int8 serving path (K7, and K3 for the
    head). -> the K7 entry of the kernels line."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        relaynet_int8 as tr,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.http_server import (
        start_in_background,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.relaynet_psrp import (
        relaynet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.server import (
        ServingLoop,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv7x3_int8 as k7,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        head_argmax as k3,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )

    rf = RELAYNET_F
    gen = np.random.default_rng(SEED + 60)

    def stage_args(h, cins, n):
        """Seeded signed int8 inputs (PReLU outputs are signed) and an
        epilogue that spreads the outputs over the int8 range."""
        xs = tuple(torch.tensor(gen.integers(-127, 128, (n, h, h, c)),
                                dtype=torch.int8, device=dev) for c in cins)
        w = torch.tensor(gen.integers(-127, 128, (rf, sum(cins), 7, 3)),
                         dtype=torch.int8, device=dev)
        std = (21 * sum(cins)) ** 0.5 * 73 * 73
        scale = torch.tensor(gen.uniform(30, 60, rf) / std,
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-5, 5, rf), dtype=torch.float32,
                            device=dev)
        return xs, k7.pack_conv7x3_weights(w), scale, bias, \
            float(gen.uniform(0.05, 1.0))

    # ------------------------------------------------------------------ 12
    phase(f"12 ReLayNet K7 vs its plain version (batch 2, every stage)")
    max_err, bad = 0, 0
    for name, h, cins, pool in relaynet_stages(rf, HW):
        args = stage_args(h, cins, 2)
        got = k7.conv7x3_int8(*args, pool=pool)
        want = k7.conv7x3_int8_reference(*args, pool=pool)
        torch.cuda.synchronize()
        got, want = (got, want) if pool else ((got,), (want,))
        mism = sum(int((a != b).sum()) for a, b in zip(got, want))
        max_err = max([max_err] + [int((a.int() - b.int()).abs().max())
                                   for a, b in zip(got, want)])
        print(f"{name:8s} {h:4d}^2 {str(cins):9s} -> {rf} pool={pool!s:5s} "
              f"outputs {[tuple(a.shape) for a in got]} mismatches {mism}",
              flush=True)
        bad += mism
        if name.startswith(("b0", "b6")):
            again = k7.conv7x3_int8(*args, pool=pool)
            torch.cuda.synchronize()
            again = again if pool else (again,)
            diff = sum(int((a != b).sum()) for a, b in zip(again, got))
            print(f"{name:8s} a second call on the same inputs: {diff} "
                  "outputs differ from the first", flush=True)
            bad += diff
    # at the b0 and b6 shapes: every 2x2 window tied (constant input, zero
    # weights: the index must be 0), and inputs and weights all +-127 (at
    # b6, cin 128, |acc| reaches 21 * 128 * 127^2 = 43,354,368)
    for name, h, cins in (("b0 stem", HW, (1,)), ("b6", HW, (rf, rf))):
        cin = sum(cins)
        x = tuple(torch.full((2, h, h, c), 5, dtype=torch.int8, device=dev)
                  for c in cins)
        bias = torch.tensor(gen.uniform(-100, 100, rf), dtype=torch.float32,
                            device=dev)
        tie = (x, k7.pack_conv7x3_weights(torch.zeros(
            (rf, cin, 7, 3), dtype=torch.int8, device=dev)),
            torch.ones(rf, device=dev), bias, 0.25)
        x = tuple(torch.full((2, h, h, c), 127, dtype=torch.int8, device=dev)
                  for c in cins)
        x[-1][:, :h // 4] = -127
        sign = torch.tensor(gen.choice([-1, 1], (rf, cin, 7, 3)), device=dev)
        sign[0::3], sign[1::3] = 1, -1
        top = 21 * cin * 127 * 127
        extreme = (x, k7.pack_conv7x3_weights((127 * sign).to(torch.int8)),
                   torch.tensor(gen.uniform(100, 200, rf) / top,
                                dtype=torch.float32, device=dev),
                   torch.tensor(gen.uniform(-5, 5, rf), dtype=torch.float32,
                                device=dev), 0.5)
        for case, args in (("ties", tie), ("+-127", extreme)):
            got = k7.conv7x3_int8(*args, pool=True)
            want = k7.conv7x3_int8_reference(*args, pool=True)
            torch.cuda.synchronize()
            mism = sum(int((a != b).sum()) for a, b in zip(got, want))
            if case == "ties" and bool(got[2].any()):
                mism += int((got[2] != 0).sum())
            max_err = max([max_err] + [int((a.int() - b.int()).abs().max())
                                       for a, b in zip(got, want)])
            print(f"{name:8s} {case:5s} pool=True: mismatches {mism}; "
                  f"indices {torch.unique(got[2]).tolist()}", flush=True)
            bad += mism
        del x, tie, extreme
    if bad:
        raise RuntimeError(f"{bad} K7 outputs differ from plain")

    # ------------------------------------------------------------------ 13
    phase(f"13 ReLayNet graph: f={rf}, {NC} classes, {HW}x{HW}, batch 8")
    model = cli.build_model("relaynet", num_classes=NC, seed=SEED,
                            device=dev)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        # random BN terms and PReLU slopes in [0.5, 1], 7x3 weights x0.75:
        # the labels then spread over all 10 classes; larger weights or
        # slopes nearer 0 leave the float graph's argmax so near ties that
        # int8 noise moves more than 5% of it (PERF.md section 4)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo_hi, normal in ((m.weight, (0.5, 1.5), False),
                                         (m.bias, (0, 0.1), True),
                                         (m.running_mean, (0, 0.1), True),
                                         (m.running_var, (0.5, 1.5), False)):
                    e = torch.empty(t.shape)
                    t.copy_(e.normal_(*lo_hi, generator=g) if normal
                            else e.uniform_(*lo_hi, generator=g))
            elif isinstance(m, torch.nn.PReLU):
                m.weight.copy_(torch.empty(1).uniform_(0.5, 1.0, generator=g))
            elif isinstance(m, torch.nn.Conv2d) and m.kernel_size == (7, 3):
                m.weight.mul_(RELAYNET_GAIN)
    t0 = time.time()
    forward, calib = cli.build_relaynet_psrp_forward(model, image_size=HW,
                                                     device=dev, seed=SEED)
    print(f"fold + calibrate (TF32 off) + quantize: {time.time() - t0:.1f} s")
    imgs = torch.tensor(
        np.random.default_rng(SEED + 2).standard_normal((8, HW, HW, 1)),
        dtype=torch.float32, device=dev)
    with torch.inference_mode():
        x = preprocess(imgs)
        lab = relaynet_psrp_forward(calib["qparams"], x, NC)
        lab_plain = relaynet_psrp_forward(calib["qparams"], x, NC,
                                          reference=True)
        q8 = tr.quantize_relaynet(calib["layers"], calib["taps"])
        ref8 = tr.relaynet_int8_forward(q8, x).argmax(-1)
        ref32 = tr.relaynet_folded_forward(calib["layers"], x).argmax(-1)
    torch.cuda.synchronize()
    graph_mism = int((lab != lab_plain).sum())
    a8 = float((lab.long() == ref8).float().mean())
    a32 = float((lab.long() == ref32).float().mean())
    hist = torch.bincount(lab.flatten().long(), minlength=NC).tolist()
    print(f"labels {tuple(lab.shape)} {lab.dtype}, class histogram {hist}")
    print(f"kernel graph vs plain graph: {graph_mism} label mismatches")
    print(f"agreement vs all-int8 oracle {a8:.6f} (> 0.995), "
          f"vs float graph {a32:.6f} (> 0.95)", flush=True)
    if graph_mism or not (a8 > 0.995 and a32 > 0.95):
        raise RuntimeError("ReLayNet graph check failed")
    del lab_plain, ref8, ref32, x
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 14
    phase("14 serve ReLayNet: ServingLoop (batch 8) + HTTP, 6 requests, "
          "2 clients")
    reqs = np.random.default_rng(SEED + 4).uniform(
        0, 255, (8, HW, HW, 1)).astype(np.float32)
    with torch.inference_mode():
        direct = forward(torch.from_numpy(reqs).to(dev)).cpu().numpy()
    posts = [reqs[i] for i in range(5)] + [reqs[5:8]]
    post_want = [direct[i] for i in range(5)] + [direct[5:8]]
    wrappers = {"conv7x3_int8": k7.conv7x3_int8,
                "head_argmax": k3.head_argmax}
    for w in wrappers.values():
        w.launches = 0
    loop = ServingLoop(forward, (HW, HW, 1), device=dev, batch_size=8,
                       max_wait_ms=5.0)
    loop.warmup()
    httpd, _ = start_in_background(loop, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    results, errors = {}, []

    def client(idx):
        try:
            for i in idx:
                results[i] = http_post(url, posts[i])
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(range(c, 6, 2),))
               for c in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.close()
    launches = {k: w.launches for k, w in wrappers.items()}
    if errors:
        raise RuntimeError(f"client errors: {errors!r}")
    ok = [np.array_equal(results[i], post_want[i]) for i in range(6)]
    n_fwd = loop.batches_run + 1  # + the warm-up batch
    print(f"{sum(ok)}/6 responses equal the direct forward; "
          f"{loop.batches_run} batches + 1 warm-up; launches {launches}, "
          f"expected {n_fwd} x {RELAYNET_LAUNCHES}", flush=True)
    if not all(ok):
        raise RuntimeError("served labels differ from the direct forward")
    if any(launches[k] != n_fwd * v for k, v in RELAYNET_LAUNCHES.items()):
        raise RuntimeError("launch counts do not match the ReLayNet graph")

    # ------------------------------------------------------------------ 15
    phase(f"15 ReLayNet times on {card} (batch 32)")
    n = 32
    total = [0.0, 0.0, 0.0]
    bounds = {"operations": 0.0, "bytes": 0.0}
    by_row = {}
    for name, h, cins, pool in relaynet_stages(rf, HW):
        args = stage_args(h, cins, n)
        with torch.inference_mode():
            ms = time_ms(lambda: k7.conv7x3_int8(*args, pool=pool))
            dms = device_ms(lambda: k7.conv7x3_int8(*args, pool=pool))
            pms = time_ms(lambda: k7.conv7x3_int8_reference(*args, pool=pool),
                          3)
        ops, nbytes = relaynet_work(h, cins, pool, n, rf)
        b_ms, b_by = bound(ops, nbytes, PEAK["int8"])
        total[0] += ms
        total[1] += pms
        total[2] += dms
        bounds[b_by] += b_ms
        row = by_row.setdefault("B14" if name.startswith("b0") else "B13",
                                [0, 0.0, 0.0, 0.0, 0.0])
        for i, v in enumerate((1, ms, pms, b_ms, dms)):
            row[i] += v
        print(f"time b{n} {name:8s} K7 kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TOPS), device_ms {dms:.4f} "
              f"({ops / dms / 1e9:.1f} TOPS, {nbytes / dms / 1e6:.1f} GB/s), "
              f"plain {pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / dms:.1f}% of the bound's rate", flush=True)
        del args
        torch.cuda.empty_cache()
    print(f"time b{n} K7 summed over the 7 stages: kernel {total[0]:.4f} ms, "
          f"device_ms {total[2]:.4f}, plain {total[1]:.4f} ms, bound "
          f"{sum(bounds.values()):.4f} ms {bounds}")
    for row, (n_st, ms, pms, b_ms, dms) in sorted(by_row.items()):
        print(f"time b{n} TPU kernel {row} ({n_st} launches per forward): "
              f"kernel {ms:.4f} ms, device_ms {dms:.4f}, plain {pms:.4f} ms, "
              f"bound {b_ms:.4f} ms")
    # K3 at ReLayNet's head: (n, 512, 512, 64) -> NC classes
    hx = torch.randint(-127, 128, (n, HW, HW, rf), dtype=torch.int8,
                       device=dev, generator=torch.Generator(
                           device=dev).manual_seed(SEED + 61))
    head = (k3.pack_head_weights(torch.tensor(
        gen.integers(-40, 41, (NC, rf, 1, 1)), dtype=torch.int8, device=dev)),
        torch.tensor(gen.uniform(30, 60, NC) / rf ** 0.5 / 73 / 40,
                     dtype=torch.float32, device=dev),
        torch.tensor(gen.uniform(-5, 5, NC), dtype=torch.float32,
                     device=dev))
    with torch.inference_mode():
        if not torch.equal(k3.head_argmax(hx, *head),
                           k3.head_argmax_reference(hx, *head)):
            raise RuntimeError("K3 differs from its plain version at "
                               "ReLayNet's head")
        h_ms = time_ms(lambda: k3.head_argmax(hx, *head))
        h_dev = device_ms(lambda: k3.head_argmax(hx, *head))
    h_bytes = n * HW * HW * (rf + 1) + NC * rf + 8 * NC
    h_bound = h_bytes / HBM * 1e3
    print(f"time b{n} K3 at ReLayNet's head ({HW}x{HW}x{rf} -> {NC}; "
          f"bit-equal to plain): event {h_ms:.4f} ms, device {h_dev:.4f} ms "
          f"(must < 0.30, aim <= 0.22), bound {h_bound:.4f} ms (bytes), "
          f"{100 * h_bound / h_dev:.2f}% of the bound's rate, "
          f"{h_bytes / h_dev / 1e6:.1f} GB/s; plan "
          f"{k3.launch_plan(hx, NC).text()}", flush=True)
    del hx, head
    torch.cuda.empty_cache()
    xb = torch.tensor(np.random.default_rng(n).uniform(0, 255, (n, HW, HW, 1)),
                      dtype=torch.float32, device=dev)
    with torch.inference_mode():
        ms = time_ms(lambda: forward(xb))
    print(f"served ReLayNet forward (z-score + graph) batch {n}: {ms:.3f} ms, "
          f"{n / ms * 1e3:.1f} B-scans/s", flush=True)
    profile_breakdown(lambda: forward(xb), 3, f"the served forward, batch {n}",
                      {"K7 conv7x3_int8": "7x3_mma",
                       "K3 head_argmax": "head_argmax"})
    del xb, forward, calib, model
    torch.cuda.empty_cache()
    return {
        "name": "conv7x3_int8", "route": "cuda",
        "source": SOURCES["conv7x3_int8"],
        "replaces": "; ".join(REPLACES["conv7x3_int8"]),
        "launches": launches["conv7x3_int8"], "max_abs_err": max_err,
        "ms": total[0], "plain_ms": total[1],
        "bound_ms": sum(bounds.values()),
        "bound_by": max(bounds, key=bounds.get),
        # no single PyTorch call computes an int8 conv with a PReLU requant
        "library_ms": None,
    }


def device_ms(fn, runs=20):
    """Device time per call of ``fn``, summed over the kernels it launches
    (``torch.profiler``): the event timings of a kernel of tens of
    microseconds carry its launch. Three windows of ``runs`` / 2 calls.
    On the card the profiler drops kernel events, more of them the longer
    the process has run (late in this script, half a window's events or
    more), and the events it keeps carry their full durations. So each
    kernel's time is the mean of its recorded events times its launches a
    call: the most it recorded in one window over the calls, rounded up
    (every kernel here launches a whole number of times a call)."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    n = max(1, runs // 2)
    kernels = {}  # name -> [recorded us, recorded events, most in a window]
    for _window in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or not e.count:
                continue
            k = kernels.setdefault(e.key, [0.0, 0, 0])
            k[0] += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
            k[1] += e.count
            k[2] = max(k[2], e.count)
    if not kernels:
        return float("nan")
    return sum(us / count * math.ceil(most / n)
               for us, count, most in kernels.values()) / 1e3


def stem_work(h, c1, cout, n):
    """(int8 ops, bytes) of one K10 call at batch n, h x h: the image read
    once, both outputs written once."""
    return (2 * n * h * h * 9 * (c1 + c1 * cout),
            n * h * h + 9 * c1 * (1 + cout) + 8 * (c1 + cout)
            + n * h * h * cout * 1.25)


def infer_eval_phases(dev, card, time_ms, model, calib, by_row):
    """Phases 16-21: the fused stem (K10), the int8 pool (K11), the
    row-packed graph, ``cli infer`` and ``cli eval``. ``model`` and
    ``calib``: phase 3's U-Net and its PSRP build; ``by_row``: phase 5's
    times per TPU kernel. -> the K10 and K11 entries of the kernels line."""
    import os
    import tempfile
    from types import SimpleNamespace

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.packed import (
        LAUNCHES_PER_FORWARD as PACKED_LAUNCHES,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.packed import (
        unet_packed_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv7x3_int8 as k7,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        head_argmax as k3,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.data import (
        SyntheticOCTConfig,
        SyntheticOCTDataset,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        Trainer,
    )

    wrappers = {"stem_conv_int8": k10.stem_conv_int8,
                "conv3x3_int8": k12.conv3x3_int8,
                "conv7x3_int8": k7.conv7x3_int8,
                "pool2x2_int8": k12.pool2x2_int8,
                "ct2x2_int8": k12.ct2x2_int8, "head_argmax": k3.head_argmax}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts(keys):
        return {k: wrappers[k].launches for k in keys}

    gen = np.random.default_rng(SEED + 70)

    def i8(shape, lo=-127, hi=128):
        return torch.tensor(gen.integers(lo, hi, shape), dtype=torch.int8,
                            device=dev)

    def vec(n, lo, hi):
        return torch.tensor(gen.uniform(lo, hi, n), dtype=torch.float32,
                            device=dev)

    def stem_args(n, h, w, c1, cout, extremes=False):
        """A seeded int8 image, weights (K1's packs), and epilogues that
        spread both requants over the int8 range, then the tensor-core
        packs (w0_m, w1_m) as the graph's qparams carry them; the stem
        biases reach 40, so a halo holding the stem of a zero-padded image
        would show. ``extremes``: +-127 images and conv1 weights, the stem
        weights all 127 and a block of 127s whose stem clips in every
        channel, conv1's channel 0 all 127 (288 * 127^2 there)."""
        if extremes:
            vals = np.array([-127, 127])
            x = torch.tensor(gen.choice(vals, (n, h, w, 1)),
                             dtype=torch.int8, device=dev)
            x[0, 4:11, 4:11] = 127
            wq0 = torch.full((c1, 1, 3, 3), 127, dtype=torch.int8,
                             device=dev)
            wq1 = torch.tensor(gen.choice(vals, (cout, c1, 3, 3)),
                               dtype=torch.int8, device=dev)
            wq1[0] = 127
            s0 = vec(c1, 1.0, 1.5) / (9 * 127)
            s1 = vec(cout, 30, 60) / ((9 * c1) ** 0.5 * 64 * 127)
        else:
            x, wq0, wq1 = i8((n, h, w, 1)), i8((c1, 1, 3, 3)), \
                i8((cout, c1, 3, 3))
            std0, std1 = 3 * 73 * 73, (9 * c1) ** 0.5 * 64 * 73
            s0, s1 = vec(c1, 30, 60) / std0, vec(cout, 30, 60) / std1
        args = (x, k12.pack_conv3x3_weights(wq0), s0, vec(c1, -5, 40),
                k12.pack_conv3x3_weights(wq1), s1, vec(cout, -5, 5))
        w_mma = (k12.pack_stem_mma_weights(wq0),
                 k12.pack_conv3x3_mma_weights(wq1))
        return args, w_mma

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k10_plan(args):
        """The plan K10's wrapper takes for these arguments."""
        x, _, s0, _, _, s1, _ = args
        return k10.stem_conv_plan(*x.shape[:3], s0.shape[0], s1.shape[0],
                                  x.data_ptr() % 16 == 0, sms)

    def k10_dp4a(args):
        """One launch of K10's dp4a body through its own C entry point."""
        x, w0, s0, b0, w1, s1, b1 = args
        N, H, W, _ = x.shape
        c1, cout = s0.shape[0], s1.shape[0]
        y = torch.empty((N, H, W, cout), dtype=torch.int8, device=dev)
        yp = torch.empty((N, H // 2, W // 2, cout), dtype=torch.int8,
                         device=dev)
        _build.check(_build.lib().octseg_stem_conv_int8(
            x.data_ptr(), w0.data_ptr(), s0.data_ptr(), b0.data_ptr(),
            w1.data_ptr(), s1.data_ptr(), b1.data_ptr(), y.data_ptr(),
            yp.data_ptr(), N, H, W, c1, w0.shape[2], 4 * w1.shape[1], cout,
            w1.shape[2], torch.cuda.current_stream().cuda_stream),
            "stem_conv_int8 (dp4a)")
        return y, yp

    pool_shapes = [(HW // 4, 4 * F), (HW // 8, 8 * F)]  # the deep pools

    # ------------------------------------------------------------------ 16
    phase("16 K10 (fused stem) and K11 (int8 pool) vs plain versions")
    max_err = {"stem_conv_int8": 0, "pool2x2_int8": 0}
    bad = 0
    k10_plans = {}
    off_body = []  # calls the plan did not put on the expected body
    for label, (n, h, w, c1, body, case) in {
            "f=32": (2, HW, HW, F, "mma", "rand"),
            "f=32 80x48": (2, 80, 48, F, "mma", "rand"),
            "f=32 +-127": (2, HW, HW, F, "mma", "ext"),
            "f=32 borders": (2, HW, HW, F, "mma", "borders"),
            "f=16": (2, HW, HW, F // 2, "dp4a", "rand")}.items():
        args, w_mma = stem_args(n, h, w, c1, c1, extremes=case == "ext")
        plan = k10_plan(args)
        k10_plans[label] = plan.text()
        got = k10.stem_conv_int8(*args, w_mma)
        want = k10.stem_conv_int8_reference(*args)
        torch.cuda.synchronize()
        mism = sum(int((a != b).sum()) for a, b in zip(got, want))
        max_err["stem_conv_int8"] = max(
            [max_err["stem_conv_int8"]] + [int((a.int() - b.int()).abs().max())
                                           for a, b in zip(got, want)])
        zero = float((got[0] == 0).float().mean())
        note = ""
        if label == "f=32":  # a second call: the same bits
            again = k10.stem_conv_int8(*args, w_mma)
            torch.cuda.synchronize()
            repeat = sum(int((a != b).sum()) for a, b in zip(again, got))
            note = f", second call differs at {repeat}"
            bad += repeat
            del again
        if case == "ext":
            note = (f", max out {int(got[0].max())}, block centre channel 0 "
                    f"{int(got[0][0, 7, 7, 0])} (conv1 sum 288 * 127^2)")
        if case == "borders":
            # the planted fault: a halo holding the stem of a zero-padded
            # image (the stem evaluated one pixel beyond the image) instead
            # of conv1's zero padding must change border outputs
            x, w0, s0, b0, w1, s1, b1 = args
            xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                         (1, 1, 1, 1)).permute(0, 2, 3, 1)
            mid = k12.conv3x3_int8_reference((xp.contiguous(),), w0, s0, b0)
            wrong = k12.conv3x3_int8_reference((mid,), w1, s1, b1)[
                :, 1:-1, 1:-1]
            caught = int((wrong != want[0]).sum())
            note = (f", a zero-padded-image halo would change {caught} "
                    f"border outputs")
            if not caught:
                raise RuntimeError("the K10 border case does not show the "
                                   "halo's padding")
            del xp, mid, wrong
        if plan.body != body:
            off_body.append(label)
        print(f"K10 {label:12s} ({n}, {h}, {w}) c1 {c1} -> {c1}: body "
              f"{plan.text()}, outputs {[tuple(a.shape) for a in got]} "
              f"mismatches {mism} (zeros {zero:.3f}){note}", flush=True)
        bad += mism
        del args, got, want
    if off_body:
        raise RuntimeError(f"K10 calls off their planned body: {off_body}")
    for n, h, c in [(2, h, c) for h, c in pool_shapes] + [(2, 32, 24)]:
        x = i8((n, h, h, c), -128, 128)
        got, want = k12.pool2x2_int8(x), k12.pool2x2_int8_reference(x)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        max_err["pool2x2_int8"] = max(max_err["pool2x2_int8"], int(
            (got.int() - want.int()).abs().max()))
        print(f"K11 ({n}, {h}, {h}, {c}): mismatches {mism}", flush=True)
        bad += mism
    if bad:
        raise RuntimeError(f"{bad} K10/K11 outputs differ from plain")

    # ------------------------------------------------------------------ 17
    phase(f"17 PSRP graph with the fused stem (f={F}, {HW}x{HW}, batch 8)")
    imgs = torch.tensor(
        np.random.default_rng(SEED + 2).standard_normal((8, HW, HW, 1)),
        dtype=torch.float32, device=dev)
    qp = calib["qparams"]
    with torch.inference_mode():
        x = preprocess(imgs)
        unfused = unet_psrp_forward(qp, x, NC, stem_fuse=False)
        reset()
        fused = unet_psrp_forward(qp, x, NC, stem_fuse=True)
        torch.cuda.synchronize()
        stem_launches = counts(FUSED_STEM_LAUNCHES)
        fused_plain = unet_psrp_forward(qp, x, NC, stem_fuse=True,
                                        reference=True)
    torch.cuda.synchronize()
    mism = int((fused != unfused).sum())
    mism_plain = int((fused != fused_plain).sum())
    graph_plan = k10.stem_conv_plan(*x.shape[:3], F, F, True, sms)
    k10_plans[f"graph b{x.shape[0]}"] = graph_plan.text()
    print(f"fused-stem labels vs unfused: {mism} mismatches; vs its plain "
          f"graph: {mism_plain}; launches {stem_launches}, expected "
          f"{FUSED_STEM_LAUNCHES}; K10 body {graph_plan.text()}", flush=True)
    if mism or mism_plain or stem_launches != FUSED_STEM_LAUNCHES:
        raise RuntimeError("fused-stem graph check failed")
    del fused_plain

    # ------------------------------------------------------------------ 18
    phase(f"18 packed graph (infer --quantize packed; f={F}, {HW}x{HW}, "
          "batch 8)")
    t0 = time.time()
    packed_fwd, pcal = cli.build_quantized_forward(
        model, "unet", "packed", image_size=HW, device=dev, seed=SEED)
    print(f"fold + calibrate + quantize: {time.time() - t0:.1f} s")
    pq = pcal["qparams"]
    with torch.inference_mode():
        reset()
        lab = unet_packed_forward(pq, x, NC)
        torch.cuda.synchronize()
        packed_launches = counts(PACKED_LAUNCHES)
        lab_plain = unet_packed_forward(pq, x, NC, reference=True)
        ref8 = tq.unet_int8_forward(
            tq.quantize_unet(pcal["layers"], pcal["taps"]), x).argmax(-1)
        ref32 = tq.folded_forward(pcal["layers"], x).argmax(-1)
    torch.cuda.synchronize()
    graph_mism = int((lab != lab_plain).sum())
    a8 = float((lab.long() == ref8).float().mean())
    a32 = float((lab.long() == ref32).float().mean())
    hist = torch.bincount(lab.flatten().long(), minlength=NC).tolist()
    print(f"labels {tuple(lab.shape)} {lab.dtype}, class histogram {hist}")
    print(f"kernel graph vs plain graph: {graph_mism} label mismatches; "
          f"agreement vs all-int8 oracle {a8:.6f} (> 0.995), vs float graph "
          f"{a32:.6f} (> 0.95); vs the PSRP graph "
          f"{float((lab == unfused).float().mean()):.6f}")
    print(f"launches {packed_launches}, expected {PACKED_LAUNCHES}",
          flush=True)
    if graph_mism or not (a8 > 0.995 and a32 > 0.95) \
            or packed_launches != PACKED_LAUNCHES:
        raise RuntimeError("packed graph check failed")
    del lab_plain, ref8, ref32, unfused, fused, lab
    torch.cuda.empty_cache()

    common = ["--image-size", str(HW), "--num-classes", str(NC),
              "--batch-size", str(INFER_BATCH), "--device", "cuda",
              "--seed", str(SEED)]
    with tempfile.TemporaryDirectory() as tmp:
        # -------------------------------------------------------------- 19
        phase(f"19 cli infer ({HW}x{HW}, {INFER_BATCH} B-scans)")
        art = os.path.join(tmp, "packed.npz")
        masks = {}
        for label, argv in (
            ("unet packed --save-quantized", ["--quantize", "packed",
                                              "--save-quantized", art]),
            ("unet packed --load-quantized", ["--quantize", "packed",
                                              "--load-quantized", art]),
            ("unet psrp", ["--quantize", "psrp"]),
            ("relaynet psrp", ["--model", "relaynet", "--quantize", "psrp"]),
        ):
            out = os.path.join(tmp, label.replace(" ", "_"))
            reset()
            t0 = time.perf_counter()
            cli.main(["infer", *common, "--out-dir", out, *argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = np.load(os.path.join(out, "masks.npy"), allow_pickle=False)
            launched = {k: v for k, v in counts(wrappers).items() if v}
            print(f"{label}: masks {m.shape} {m.dtype}, classes "
                  f"{np.bincount(m.ravel(), minlength=NC).tolist()}, "
                  f"{wall:.2f} s (model, calibration, data and forward), "
                  f"launches {launched}", flush=True)
            if m.shape != (INFER_BATCH, HW, HW) or m.min() < 0 \
                    or m.max() >= NC:
                raise RuntimeError(f"cli infer {label}: bad masks")
            masks[label] = m
        same = np.array_equal(masks["unet packed --save-quantized"],
                              masks["unet packed --load-quantized"])
        print(f"--save-quantized then --load-quantized: identical masks "
              f"{same}")
        if not same:
            raise RuntimeError("the quantized artifact changed the masks")

        # -------------------------------------------------------------- 20
        phase(f"20 cli eval --quantize psrp ({HW}x{HW}, --num-val 8)")
        # the labels and masks cli eval scores, kept to score them again on
        # the CPU
        seen = []
        evaluate = Trainer.evaluate

        def keeping(self, state, dataset, *a, predict_fn=None, **kw):
            def epoch(e):
                for images, labels in dataset.epoch(e):
                    seen.append([labels.cpu()])
                    yield images, labels

            def predict(st, images):
                p = predict_fn(st, images)
                seen[-1].append(p.cpu())
                return p

            return evaluate(self, state, SimpleNamespace(epoch=epoch), *a,
                            predict_fn=predict, **kw)

        argv = ["eval", *common[:4], "--batch-size", "8", *common[6:],
                "--quantize", "psrp", "--num-val", "8"]
        with swapped(Trainer, evaluate=keeping):
            m = cli.main(argv)
        cpu_trainer, _ = cli.build_eval_trainer(cli.parser().parse_args(
            ["eval", "--num-classes", str(NC), "--device", "cpu"]))
        t0 = time.perf_counter()
        cpu = cpu_trainer.evaluate(
            None, SimpleNamespace(epoch=lambda e: iter(
                [(p, lab_) for lab_, p in seen])),
            predict_fn=lambda s, p: p)
        cpu_s = time.perf_counter() - t0
        total = int(m["confusion"].sum())
        worst = max(float(np.nanmax(np.abs(np.asarray(m[k], np.float64)
                                           - np.asarray(cpu[k], np.float64))))
                    for k in m if k != "confusion")
        nan_same = all(np.array_equal(np.isnan(np.asarray(m[k], float)),
                                      np.isnan(np.asarray(cpu[k], float)))
                       for k in m)
        print(f"{len(seen)} batch(es) scored; confusion sum {total} (pixels "
              f"{8 * HW * HW}), equal to the CPU's "
              f"{np.array_equal(m['confusion'], cpu['confusion'])}; largest "
              f"metric difference from the CPU {worst:.3e} (limit 1e-4), "
              f"NaNs in the same places {nan_same}; CPU scoring "
              f"{cpu_s:.2f} s", flush=True)
        if total != 8 * HW * HW or not worst <= 1e-4 or not nan_same \
                or not np.array_equal(m["confusion"], cpu["confusion"]):
            raise RuntimeError("cli eval check failed")
        del cpu_trainer, seen

    # ------------------------------------------------------------------ 21
    phase(f"21 fused stem, int8 pool and the packed graph: times on {card}")
    n = 32
    l0, l1 = qp["blk0_conv0"], qp["blk0_conv1"]
    xq = i8((n, HW, HW, 1))
    k10_args = (xq, l0["w_k"], l0["scale"], l0["bias"], l1["w_k"],
                l1["scale"], l1["bias"])
    k10_w_mma = (l0["w_m"], l1["w_m"])
    k10_run = k10_plan(k10_args)
    k10_plans[f"b{n}"] = k10_run.text()

    def two_launches():
        mid = k12.conv3x3_int8((xq,), l0["w_k"], l0["scale"], l0["bias"],
                               w_mma=l0["w_m"])
        return k12.conv3x3_int8((mid,), l1["w_k"], l1["scale"], l1["bias"],
                                pool=True, w_mma=l1["w_m"])

    k10_runs = {"K1 + K1": two_launches,
                "K10": lambda: k10.stem_conv_int8(*k10_args, k10_w_mma),
                "K10 dp4a": lambda: k10_dp4a(k10_args)}
    with torch.inference_mode():
        outs = {k: fn() for k, fn in k10_runs.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for k in ("K10", "K10 dp4a")
                   for a, b in zip(outs[k], outs["K1 + K1"]))
        del outs
        if not same:
            raise RuntimeError(f"K10's bodies differ from K1 + K1 at batch "
                               f"{n}")
        ev, dv = {}, {}
        for turn in ("K1 + K1", "K10", "K10 dp4a", "K10 dp4a", "K10",
                     "K1 + K1"):
            ev.setdefault(turn, []).append(time_ms(k10_runs[turn]))
            dv.setdefault(turn, []).append(device_ms(k10_runs[turn]))
        k10_plain = time_ms(lambda: k10.stem_conv_int8_reference(*k10_args),
                            3)
    k10_ms, dev_k10 = statistics.median(ev["K10"]), statistics.median(
        dv["K10"])
    dev_two, dev_dp4a = statistics.median(dv["K1 + K1"]), statistics.median(
        dv["K10 dp4a"])
    k10_bound, k10_by = bound(*stem_work(HW, F, F, n), PEAK["int8"])
    print(f"time b{n} K10 stem+blk0_conv1+pool (plan {k10_run.text()}), in "
          f"turns K1+K1, K10, dp4a, dp4a, K10, K1+K1 (outputs bit-equal): "
          f"mma.sync body event {ev['K10']} ms, device {dv['K10']} ms; dp4a "
          f"body event {ev['K10 dp4a']} ms, device {dv['K10 dp4a']} ms; K1 "
          f"stem + K1 blk0_conv1 event {ev['K1 + K1']} ms, device "
          f"{dv['K1 + K1']} ms; plain {k10_plain:.4f} ms; bound "
          f"{k10_bound:.4f} ms ({k10_by}), {100 * k10_bound / dev_k10:.2f}% "
          f"of the bound's rate; device K10 / (K1 + K1) "
          f"{dev_k10 / dev_two:.4f} (must < 1), dp4a / K10 "
          f"{dev_dp4a / dev_k10:.2f}x", flush=True)
    del xq, k10_args, k10_runs
    k11 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "operations": 0.0, "bytes": 0.0}
    for h, c in pool_shapes:
        xp = i8((n, h, h, c), -128, 128)
        with torch.inference_mode():
            ms = time_ms(lambda: k12.pool2x2_int8(xp))
            pms = time_ms(lambda: k12.pool2x2_int8_reference(xp), 3)
            lms = time_ms(lambda: xp.unflatten(1, (h // 2, 2)).unflatten(
                3, (h // 2, 2)).amax((2, 4)))
            dev_ms = device_ms(lambda: k12.pool2x2_int8(xp))
            dev_lib = device_ms(lambda: xp.unflatten(1, (h // 2, 2)).unflatten(
                3, (h // 2, 2)).amax((2, 4)))
        nbytes = n * h * h * c * 1.25
        b_ms, b_by = bound(3 * n * h * h * c / 4, nbytes, PEAK["int8"])
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                       (b_by, b_ms)):
            k11[key] += v
        print(f"time b{n} K11 ({h}^2 x {c}): kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s), plain {pms:.4f} ms, library "
              f"amax {lms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); device time "
              f"(profiler) kernel {dev_ms:.4f} ms "
              f"({nbytes / dev_ms / 1e6:.0f} GB/s), amax {dev_lib:.4f} ms",
              flush=True)
        del xp
    for row, src in (("B15a", "B1"), ("B15b", "B2"), ("B15c", "B7")):
        n_st, ms, pms, b_ms = by_row[src]
        print(f"time b32 TPU kernel {row} (packed graph, {n_st} launches "
              f"per forward, the shapes of {src}): kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound {b_ms:.4f} ms")
    torch.cuda.empty_cache()

    def psrp_fwd(images, stem_fuse=False):
        return unet_psrp_forward(qp, preprocess(images), NC,
                                 stem_fuse=stem_fuse)

    graphs = (("packed", packed_fwd),
              ("psrp, fused stem off", psrp_fwd),
              ("psrp, fused stem on",
               lambda b: psrp_fwd(b, stem_fuse=True)))
    for nb in (32, 128):
        xb = torch.tensor(
            np.random.default_rng(nb).uniform(0, 255, (nb, HW, HW, 1)),
            dtype=torch.float32, device=dev)
        fwd = {}
        # in turns: packed, off, on, on, off, packed
        for label, fn in graphs + graphs[::-1]:
            with torch.inference_mode():
                ms = time_ms(lambda: fn(xb))
            fwd.setdefault(label, []).append(ms)
            print(f"forward ({label}, z-score + graph) batch {nb}: "
                  f"{ms:.3f} ms, {nb / ms * 1e3:.1f} B-scans/s", flush=True)
        on, off = (statistics.mean(fwd[f"psrp, fused stem {k}"])
                   for k in ("on", "off"))
        print(f"forward batch {nb}: fused stem on {on:.3f} ms, off "
              f"{off:.3f} ms (means of two turns), on / off {on / off:.4f} "
              f"(must <= 1)", flush=True)
        del xb
        torch.cuda.empty_cache()
    args = cli.parser().parse_args(
        ["eval", "--image-size", str(HW), "--num-classes", str(NC),
         "--device", "cuda", "--quantize", "psrp"])
    trainer, state = cli.build_eval_trainer(args)
    ds = SyntheticOCTDataset(SyntheticOCTConfig(height=HW, width=HW,
                                                num_layers=NC - 2, seed=99),
                             8, 8, dev)

    def predict(_state, images):
        return psrp_fwd(images)

    for contour in (True, False, True):
        trainer.evaluate(state, ds, contour_metrics=contour,
                         predict_fn=predict)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.evaluate(state, ds, contour_metrics=contour,
                             predict_fn=predict)
        torch.cuda.synchronize()
        print(f"Trainer.evaluate, one batch of 8 (synthetic data, the psrp "
              f"graph, contour metrics {contour}): "
              f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms", flush=True)
    del trainer, state, ds, packed_fwd, pcal
    torch.cuda.empty_cache()
    return [{
        "name": "stem_conv_int8", "route": "cuda",
        "source": SOURCES["stem_conv_int8"],
        "replaces": "; ".join(REPLACES["stem_conv_int8"]),
        "launches": stem_launches["stem_conv_int8"],
        "max_abs_err": max_err["stem_conv_int8"], "ms": k10_ms,
        "plain_ms": k10_plain, "bound_ms": k10_bound, "bound_by": k10_by,
        "device_ms": dev_k10, "plan": k10_plans,
        # no single PyTorch call computes two int8 convs with requants
        "library_ms": None,
    }, {
        "name": "pool2x2_int8", "route": "cuda",
        "source": SOURCES["pool2x2_int8"],
        "replaces": "; ".join(REPLACES["pool2x2_int8"]),
        "launches": packed_launches["pool2x2_int8"],
        "max_abs_err": max_err["pool2x2_int8"], "ms": k11["ms"],
        "plain_ms": k11["plain_ms"],
        "bound_ms": k11["operations"] + k11["bytes"],
        "bound_by": ("operations" if k11["operations"] >= k11["bytes"]
                     else "bytes"),
        "library_ms": k11["library_ms"],
    }]


def column_softargmax_f32(x):
    """The JAX reference's arithmetic in float32 (``torch.softmax``, then the
    two weighted sums): as correct as the float64 plain version of K12, its
    softmax differs from it in the last bits. With K6's plain version in
    float32 sums it gives the floor of the phase-24 comparison."""
    import torch

    sm = torch.softmax(x.float(), dim=2)
    rows = torch.arange(x.shape[2], dtype=torch.float32,
                        device=x.device).view(1, 1, -1, 1)
    pos = torch.sum(sm * rows, dim=2)
    std = torch.sqrt(torch.sum(sm * (rows - pos.unsqueeze(2)) ** 2, dim=2))
    return sm, pos, std


def column_work(shape):
    """(fp32 operations, bytes) of one K12 call: x read once, sm written
    once, pos and std written once; per element the exp, the division and
    about eight adds and multiplies."""
    B, L, H, W = shape
    n = B * L * H * W
    return 10 * n, 8 * n + 8 * B * L * W


def sdnet_phases(dev, card, time_ms):
    """Phases 22-25: SDNet's forward and its composite train step on K12
    (and K6 in every train-mode BatchNorm). -> the K12 entry of the kernels
    line."""
    import copy

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        column_softargmax as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
        get_model,
        list_models,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.sdnet_pipeline import (
        SDNetTrainer,
    )

    wrappers = {"column_softargmax": k12.column_softargmax_forward,
                "bn_pair_sums": k6.pair_sums}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def plain(k6_fn=k6.pair_sums_reference):
        """K12 swapped for its plain version, K6 for ``k6_fn``."""
        stack = contextlib.ExitStack()
        stack.enter_context(swapped(
            k12, column_softargmax=k12.column_softargmax_reference))
        stack.enter_context(swapped(k6, pair_sums=k6_fn))
        return stack

    print(f"float32 settings (PyTorch's defaults, both sides of every "
          f"comparison): cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    # the forward's and the curvature table's L at batch 8, odd H and W,
    # and an H past the register body's 512 rows
    shapes = [(8, 3, HW, HW), (8, 11, HW, HW), (2, 5, 100, 200),
              (1, 2, 600, 96)]

    # ------------------------------------------------------------------ 22
    phase("22 K12 (column softmax, position, std) vs its plain version")
    max_err = 0.0
    bad = 0
    for shape in shapes:
        x = torch.randn(shape, generator=gen, device=dev) * 3
        got = k12.column_softargmax_forward(x)
        want = k12.column_softargmax_reference(x)
        torch.cuda.synchronize()
        H = shape[2]
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        lims = (1e-6, 1e-5 * H, 1e-5 * H)
        max_err = max([max_err] + errs)
        ok = all(e <= t for e, t in zip(errs, lims))
        print(f"K12 {shape} ({k12.column_softargmax_plan(*shape).text()}): "
              f"max abs error sm {errs[0]:.3e} (limit 1e-6), pos "
              f"{errs[1]:.3e}, std {errs[2]:.3e} (limit {lims[1]:.3e})",
              flush=True)
        bad += not ok
        # the backward on random cotangents against autograd through the
        # plain version
        cot = [torch.randn(t.shape, generator=gen, device=dev) for t in got]
        grads = []
        for fn in (k12.column_softargmax, k12.column_softargmax_reference):
            xs = x.clone().requires_grad_(True)
            sum(torch.sum(o * c) for o, c in zip(fn(xs), cot)).backward()
            grads.append(xs.grad)
        rel = float((grads[0] - grads[1]).abs().max()
                    / grads[1].abs().max())
        print(f"K12 {shape} backward: max abs error / max |dx| {rel:.3e} "
              f"(limit 1e-5)", flush=True)
        bad += not rel <= 1e-5
        del x, got, want, cot, grads, xs
    x = torch.randn((2, 3, 64, 40), generator=gen, device=dev)
    x[1, 2, 17, 5] = 1e4  # a one-hot column: std = 0
    xs = x.requires_grad_(True)
    sm, pos, std = k12.column_softargmax(xs)
    (torch.sum(sm * torch.linspace(-1, 1, 64, device=dev).view(1, 1, -1, 1))
     + torch.sum(pos)).backward()
    finite = bool(torch.isfinite(xs.grad).all())
    print(f"one-hot column: std {float(std[1, 2, 5].detach())}, no std "
          f"cotangent, gradient finite {finite}")
    bad += not finite or float(std[1, 2, 5].detach()) != 0.0
    # K6 at the BatchNorm shapes SDNet adds: the gates' psi (C = 1), the
    # encoder's dense features (M = batch), its 16-wide convs
    for shape in ((SDNET_TRAIN_BATCH, HW, HW, 1), (SDNET_TRAIN_BATCH, 32),
                  (SDNET_TRAIN_BATCH, HW // 2, HW // 2, 16)):
        for two in (False, True):
            a = torch.randn(shape, generator=gen, device=dev) + 1.0
            b = torch.randn(shape, generator=gen, device=dev) + 1.0 \
                if two else None
            got, want = k6.pair_sums(a, b), k6.pair_sums_reference(a, b)
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / want.abs()).max())
            print(f"K6 {shape} two={two}: relative error {rel:.3e} (limit "
                  f"1e-6)", flush=True)
            bad += not rel <= 1e-6
    if bad:
        raise RuntimeError(f"{bad} K12/K6 checks failed")
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 23
    phase(f"23 SDNet forward (full width, {SDNET_NC} classes, {HW}x{HW}, "
          f"batch {SDNET_BATCH}, eval)")
    reset()
    smoke = io.StringIO()
    with contextlib.redirect_stdout(smoke):
        cli.main(["smoke", "--model", "all", "--device", "cuda",
                  "--strict"])
    torch.cuda.synchronize()
    print(smoke.getvalue().rstrip())
    print(f"cli smoke --model all: launches {counts()}")
    oks = sum(" ok " in line for line in smoke.getvalue().splitlines())
    if oks != len(list_models()):
        raise RuntimeError(f"cli smoke: {oks} ok lines for "
                           f"{len(list_models())} models")
    if counts()["column_softargmax"] != 1:
        raise RuntimeError("cli smoke's SDNet did not launch K12 once")
    model = get_model("sdnet", num_classes=SDNET_NC, img_size=HW,
                      seed=SEED).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    xb, _ = train_batch(dev, SDNET_BATCH, SEED + 81, SDNET_NC)
    xb = xb.permute(0, 3, 1, 2).contiguous()
    eps = torch.randn((SDNET_BATCH, 15), generator=gen, device=dev)
    with torch.no_grad():
        reset()
        out = model(xb, eps=eps)
        torch.cuda.synchronize()
        fwd_launches = counts()
        with plain():
            ref = model(xb, eps=eps)
    torch.cuda.synchronize()
    diffs = {k: float((out[k] - ref[k]).abs().max())
             for k in ("prob_map", "clean_masks", "layer_positions")}
    flips = int((out["hard_anatomy"] != ref["hard_anatomy"]).sum())
    finite = all(bool(torch.isfinite(t).all()) for k, t in out.items()
                 if k != "extra_losses")
    print(f"SDNet: {n_params:,} parameters; outputs "
          f"{ {k: tuple(t.shape) for k, t in out.items() if k != 'extra_losses'} }"
          f", all finite {finite}")
    print(f"launches per forward {fwd_launches} (expected K12 1, K6 0)")
    print(f"kernel forward vs plain-version forward: prob_map "
          f"{diffs['prob_map']:.3e}, clean_masks {diffs['clean_masks']:.3e} "
          f"(limits 1e-5), layer positions {diffs['layer_positions']:.3e} "
          f"(limit {1e-5 * HW:.3e}); hard-anatomy values that differ "
          f"{flips} of {out['hard_anatomy'].numel()} (a mask within float32 "
          f"rounding of a .5 tie)", flush=True)
    if fwd_launches != {"column_softargmax": 1, "bn_pair_sums": 0} \
            or not finite or diffs["prob_map"] > 1e-5 \
            or diffs["clean_masks"] > 1e-5 \
            or diffs["layer_positions"] > 1e-5 * HW:
        raise RuntimeError("SDNet forward check failed")
    # the card against the CPU (the port's CPU path is held against JAX) on
    # two 128x128 crops, float32 without TF32 on the card
    side = min(128, HW)
    small = get_model("sdnet", num_classes=SDNET_NC, img_size=side, seed=SEED)
    xs_ = xb[:2, :, :side, :side].contiguous()
    with torch.no_grad():
        want = small.eval()(xs_.cpu(), eps=eps[:2].cpu())
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            got = small.to(dev)(xs_, eps=eps[:2])
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    cpu_diffs = {k: float((got[k].cpu() - want[k]).abs().max())
                 for k in ("clean_masks", "layer_positions",
                           "reconstruction", "z_mean")}
    cpu_flips = float((got["hard_anatomy"].cpu()
                       != want["hard_anatomy"]).float().mean())
    print(f"card vs CPU, 2 crops of {side}x{side}, TF32 off: max abs "
          f"differences {cpu_diffs} (limits 1e-4, positions 1e-3 * {side}); "
          f"hard-anatomy share that differs {cpu_flips:.2e} (limit 1e-3)",
          flush=True)
    if any(v > (1e-3 * side if k == "layer_positions" else 1e-4)
           for k, v in cpu_diffs.items()) or cpu_flips > 1e-3:
        raise RuntimeError("SDNet on the card differs from the CPU")
    del out, ref, small, got, want
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 24
    trainer = SDNetTrainer(img_size=HW, seed=SEED, device=dev)
    phase(f"24 SDNetTrainer: five steps (full width, {HW}x{HW}, batch "
          f"{SDNET_TRAIN_BATCH}, Adam {trainer.learning_rate}, one synthetic "
          f"batch, one noise draw, cuDNN deterministic)")
    # cuDNN's default convolution backward sums in an order that changes
    # from run to run; round() in the hard anatomy carries such a last bit
    # into the loss within a few steps, so the trained state, and every
    # reading below, would differ between runs (PERF.md section 6). The
    # noise is drawn once, so the five losses differ only by the steps.
    torch.backends.cudnn.deterministic = True
    initial = copy.deepcopy(trainer.model.state_dict())
    state = trainer.init()
    step = trainer.make_train_step()
    xt, yt = train_batch(dev, SDNET_TRAIN_BATCH, SEED + 82, SDNET_NC)
    noise = torch.Generator(device=dev).manual_seed(SEED + 83)
    eps_t = torch.randn((SDNET_TRAIN_BATCH, 15), generator=noise, device=dev)
    losses = []
    reset()
    t0 = time.perf_counter()
    for _ in range(5):
        loss, metrics = step(state, xt, yt, eps=eps_t)
        losses.append(float(loss))
    torch.cuda.synchronize()
    train_launches = counts()
    print(f"five steps in {time.perf_counter() - t0:.2f} s: losses "
          f"{[round(v, 6) for v in losses]}; last terms "
          f"{ {k: round(float(v), 6) for k, v in metrics.items()} }")
    want_launches = {"column_softargmax": 5,
                     "bn_pair_sums": 5 * SDNET_K6_PER_STEP}
    print(f"launches {train_launches}, expected {want_launches}", flush=True)
    if not all(math.isfinite(v) for v in losses) or not losses[4] < losses[0]:
        raise RuntimeError(f"SDNet train losses {losses}")
    if train_launches != want_launches:
        raise RuntimeError("launch counts do not match the SDNet train step")
    trained = copy.deepcopy(trainer.model.state_dict())
    # the same five steps again from the same state and a new Adam: K6 and
    # K12 add in a fixed order, so the losses repeat bit for bit
    trainer.model.load_state_dict(initial)
    state = trainer.init()
    again = [float(step(state, xt, yt, eps=eps_t)[0]) for _ in range(5)]
    print(f"the five steps again from the initial state: losses repeat bit "
          f"for bit {again == losses}", flush=True)
    if again != losses:
        raise RuntimeError(f"SDNet train losses do not repeat: {again}")
    del initial

    def loss_and_grads(labels, half=True):
        """(loss, {term: value}, {parameter: gradient}) of one step from the
        trained state; ``half``: of the segmentation half of the loss."""
        trainer.model.load_state_dict(trained)
        trainer.model.zero_grad(set_to_none=True)
        loss, terms = trainer.loss_fn(xt, labels, eps=eps_t)
        if half:
            loss = (terms["ce"] + trainer.w_topo * terms["topology"]
                    + trainer.w_cont * terms["continuity"]
                    + trainer.w_curv * terms["curvature"])
        loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()),
                {k: float(v.detach()) for k, v in terms.items()},
                {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 .detach().double()
                 for n, p in trainer.model.named_parameters()})

    def compare(a, b):
        """-> (relative loss, {term: |difference| / loss}, whole-gradient
        cosine, (lowest per-tensor cosine over the tensors above a norm of
        1e-3, its tensor))."""
        u = torch.cat([g.flatten() for g in a[2].values()])
        v = torch.cat([g.flatten() for g in b[2].values()])
        low = (1.0, "")
        for n in a[2]:
            p, q = a[2][n].flatten(), b[2][n].flatten()
            if min(float(p.norm()), float(q.norm())) > 1e-3:
                low = min(low, (float(p @ q / (p.norm() * q.norm())), n))
        return (abs(a[0] - b[0]) / abs(b[0]),
                {k: abs(a[1][k] - b[1][k]) / abs(b[0]) for k in a[1]},
                float(u @ v / (u.norm() * v.norm())), low)

    def show(label, c):
        print(f"{label}: relative loss {c[0]:.3e}; terms (difference / loss) "
              f"{ {k: f'{v:.1e}' for k, v in c[1].items()} }; whole-gradient "
              f"cosine {c[2]:.9f}; lowest per-tensor cosine {c[3][0]:.6f} "
              f"({c[3][1]})", flush=True)

    def passes(c):
        return c[0] < SDNET_GATE["loss"] and c[2] > SDNET_GATE["cosine"]

    # What bounds this comparison:
    # - the CE reads log(clip(mask, 1e-7)); below the retina the synthetic
    #   labels are class 0, whose mask there is c0 - c1 of two cumulative
    #   sums within a few ulps of 1, rounding residue. The step is read at
    #   labels = the argmax of the trained model's own masks, as the CPU
    #   test against JAX does, where every labelled mask is >= 1/4;
    # - the hard anatomy is round(masks): a last-bit change of K12 or of
    #   any BatchNorm's sums rounds some values near .5 the other way, and
    #   the modality encoder (a BatchNorm over 4 rows of dense features)
    #   and the decoder carry each such flip into the loss and every
    #   gradient. So the gates read the segmentation half of the loss (CE,
    #   topology, continuity, curvature: the U-Net, the heads, the
    #   LayerEngine, 38 BatchNorms, no rounding); the whole loss is shown.
    with torch.no_grad(), plain():
        trainer.model.load_state_dict(trained)
        trainer.model.train()
        argmax = trainer.model(xt.permute(0, 3, 1, 2), eps=eps_t)[
            "clean_masks"].argmax(1)

    sums = k6.pair_sums

    def f32_sums(a, b=None):
        """K6's plain version with float32 sums."""
        a2 = a.reshape(-1, a.shape[-1]).float()
        b2 = a2 if b is None else b.reshape(-1, b.shape[-1]).float()
        return torch.stack([a2.sum(0), (a2 * b2).sum(0)])

    def k6_sums_high(a, b=None):
        """K6 with its sums 0.5% high."""
        return sums(a, b) * 1.005

    # K6's wrapper counts its launches under its module name, which points
    # at the fault while it runs
    k6_sums_high.launches = 0
    kern = loss_and_grads(argmax)
    with swapped(k12, column_softargmax=k12.column_softargmax_reference):
        k12_only = compare(kern, loss_and_grads(argmax))
    with plain():
        ref = loss_and_grads(argmax)
    every = compare(kern, ref)
    with swapped(k12, column_softargmax=column_softargmax_f32), \
            swapped(k6, pair_sums=f32_sums):
        floor = compare(loss_and_grads(argmax), ref)
    with swapped(k6, pair_sums=k6_sums_high):
        fault = compare(loss_and_grads(argmax), ref)
    show("one step from the trained state, segmentation half, K12 vs its "
         "plain version (K6 on both sides)", k12_only)
    show("segmentation half, every kernel vs every plain version", every)
    show("  floor: the plain versions in float32 (K12's softmax, K6's sums) "
         "vs in float64", floor)
    show("  planted fault: K6 sums 0.5% high vs the plain versions", fault)
    whole = loss_and_grads(argmax, half=False)
    with plain():
        whole = compare(whole, loss_and_grads(argmax, half=False))
    show("whole loss, every kernel vs every plain version (not gated: "
         "hard-anatomy values that round the other way)", whole)
    del kern, ref
    print(f"gates (segmentation half, argmax labels): relative loss < "
          f"{SDNET_GATE['loss']} and whole-gradient cosine > "
          f"{SDNET_GATE['cosine']}, for K12 and for every kernel; the "
          f"planted K6 fault must fail them")
    if not (passes(k12_only) and passes(every)):
        raise RuntimeError("SDNet step: the kernels and their plain versions "
                           "disagree")
    if passes(fault):
        raise RuntimeError("SDNet step: the gate does not see a planted K6 "
                           "fault")
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 25
    phase(f"25 SDNet times on {card}")
    k12_row = {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
               "operations": 0.0, "bytes": 0.0}
    # device ms: must, aim (PERF.md, section 6); none at the step's shape
    k12_goals = {shapes[0]: (0.030, 0.020), shapes[1]: (0.11, 0.070)}
    for shape in shapes[:2] + [(SDNET_TRAIN_BATCH, 3, HW, HW)]:
        x = torch.randn(shape, generator=gen, device=dev)
        with torch.no_grad():
            ms = time_ms(lambda: k12.column_softargmax_forward(x))
            pms = time_ms(lambda: k12.column_softargmax_reference(x))
            dev_ms = device_ms(lambda: k12.column_softargmax_forward(x))
        ops, nbytes = column_work(shape)
        b_ms, b_by = bound(ops, nbytes, PEAK["fp32"])
        if shape in k12_goals:  # the kernels line: the two batch-8 shapes
            for key, v in (("ms", ms), ("plain_ms", pms),
                           ("device_ms", dev_ms), (b_by, b_ms)):
                k12_row[key] += v
        goal = (" (must < {}, aim <= {})".format(*k12_goals[shape])
                if shape in k12_goals else "")
        print(f"time K12 {shape} "
              f"({k12.column_softargmax_plan(*shape).text()}): kernel "
              f"{ms:.4f} ms (device {dev_ms:.4f} ms, "
              f"{nbytes / dev_ms / 1e6:.0f} GB/s, {100 * b_ms / dev_ms:.2f}% "
              f"of the bound's rate){goal}, plain {pms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)", flush=True)
        del x
    with torch.no_grad():
        ms = time_ms(lambda: model(xb, eps=eps), 5)
    print(f"SDNet forward batch {SDNET_BATCH}: {ms:.3f} ms, "
          f"{SDNET_BATCH / ms * 1e3:.1f} B-scans/s", flush=True)
    del model, xb
    torch.cuda.empty_cache()
    trainer.model.load_state_dict(trained)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, xt, yt, generator=noise)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(state, xt, yt, generator=noise)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"SDNet train step batch {SDNET_TRAIN_BATCH}: {ms:.3f} ms, "
          f"{SDNET_TRAIN_BATCH / ms * 1e3:.1f} B-scans/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    profile_breakdown(lambda: step(state, xt, yt, generator=noise), 3,
                      f"SDNet train steps at batch {SDNET_TRAIN_BATCH}",
                      {"K12 column_softargmax": "column_softargmax",
                       "K6 bn_pair_sums": "pair_sums"})
    del trainer, state, step
    torch.cuda.empty_cache()
    return {
        "name": "column_softargmax", "route": "cuda",
        "source": SOURCES["column_softargmax"],
        "replaces": "; ".join(REPLACES["column_softargmax"]),
        "launches": train_launches["column_softargmax"],
        "max_abs_err": max_err, "ms": k12_row["ms"],
        "plain_ms": k12_row["plain_ms"],
        "device_ms": k12_row["device_ms"],
        "bound_ms": k12_row["operations"] + k12_row["bytes"],
        "bound_by": ("operations" if k12_row["operations"]
                     >= k12_row["bytes"] else "bytes"),
        # no single PyTorch call computes the softmax, position and std
        "library_ms": None,
    }


def head_work(h, cin, cout, n, nc=NC):
    """(int8 ops, bytes) of K1 with the fused head at batch n: the input
    read once, the labels written once."""
    return (2 * n * h * h * (9 * cin * cout + cout * nc),
            n * h * h * cin + 9 * cin * cout + cout * nc + 8 * (cout + nc)
            + n * h * h)


def int4_phases(dev, card, time_ms, model, calib):
    """Phases 26-30: the w4a4 serving mode (``--quantize int4``) and the
    fused head on K1 and K2. ``model`` and ``calib``: phase 3's U-Net and
    its PSRP build. -> the kernels line's entries of the w4a4 functions of
    K1 and K2 and of K1's fused head."""
    import os
    import tempfile

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.http_server import (
        start_in_background,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        act4,
        quantize_unet_psrp,
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.server import (
        ServingLoop,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        head_argmax as k3,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )

    wrappers = {"conv3x3_int8": k12.conv3x3_int8, "ct2x2_int8": k12.ct2x2_int8,
                "head_argmax": k3.head_argmax}
    plains = {"conv3x3_int8": k12.conv3x3_int8_reference,
              "ct2x2_int8": k12.ct2x2_int8_reference}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    gen = np.random.default_rng(SEED + 90)

    def i8(shape, lo=-127, hi=128):
        return torch.tensor(gen.integers(lo, hi, shape), dtype=torch.int8,
                            device=dev)

    layers, taps = calib["layers"], calib["taps"]
    q8 = calib["qparams"]
    modes = {"w4a4": True, "w4": "w4", "a4": "a4"}
    qps = {m: quantize_unet_psrp(layers, taps, F, deep_int4=v, device=dev)
           for m, v in modes.items()}

    def layer_name(name):
        return name.split()[-1]  # "stem blk0_conv0" -> "blk0_conv0"

    def stage_call(qp, name, kernel, shape, n, head=False):
        """(wrapper name, args, kwargs) of one stage of ``qp``'s graph at
        batch n on seeded inputs in the value range the stage reads: +-7
        where the graph stores 4-bit values, else the int8 range."""
        lw = qp[layer_name(name)]
        if kernel == "conv3x3_int8":
            h, cins, cout, pool = shape
            four = -7 in (lw["knobs"]["pad_vals"] or ())
            xs = tuple(i8((n, h, h, c), *((-7, 8) if four else ()))
                       for c in cins)
            kw = dict(lw["knobs"], pool=pool, w_mma=lw.get("w_m"))
            if head:
                hd = qp["head"]
                kw["head"] = (hd["w_k"], hd["scale"], hd["bias"])
            return kernel, (xs, lw["w_k"], lw["scale"], lw["bias"]), kw
        h, cin, cout = shape
        four = act4(qp) and name in ("ct0", "ct1")
        x = i8((n, h, h, cin), *((-7, 8) if four else ()))
        return kernel, (x, lw["w_k"], lw["scale"], lw["bias"]), lw["knobs"]

    def as_tuple(t):
        return t if isinstance(t, tuple) else (t,)

    def w4a4_stage(qp, name):
        """Whether a stage's function differs from the int8 graph's: its
        epilogue, or 4-bit weights."""
        lw, l8 = qp[name], q8[name]
        return (lw.get("knobs") != l8.get("knobs")
                or not torch.equal(lw["bias"], l8["bias"])
                or int(lw["w_q"].abs().max()) <= 7)

    blk8 = next(s for s in stages() if s[0] == "blk8_conv1")

    # ------------------------------------------------------------------ 26
    phase("26 K1 and K2 with the w4a4 knobs, and K1's fused head, vs plain "
          "versions (batch 2, every stage)")
    max_err = {"conv3x3_int8": 0, "ct2x2_int8": 0, "head": 0}
    bad = 0
    cases = [(m, s) for m in modes for s in stages() if s[1] != "head_argmax"]
    cases += [("int8", blk8), ("w4a4", blk8)]
    for i, (mode, (name, kernel, shape)) in enumerate(cases):
        head = i >= len(cases) - 2
        qp = q8 if mode == "int8" else qps[mode]
        kernel, args, kw = stage_call(qp, name, kernel, shape, 2, head)
        got = as_tuple(wrappers[kernel](*args, **kw))
        want = as_tuple(plains[kernel](*args, **kw))
        torch.cuda.synchronize()
        mism = sum(int((g != w).sum()) for g, w in zip(got, want))
        key = "head" if head else kernel
        max_err[key] = max([max_err[key]] + [
            int((g.int() - w.int()).abs().max()) for g, w in zip(got, want)])
        lim = max(int(g.abs().max()) for g in got)
        what = "fused head" if head else \
            "w4a4 knobs" if w4a4_stage(qp, layer_name(name)) else "int8"
        print(f"{mode:4s} {name:16s} {kernel:13s} {str(shape):28s} {what:10s}"
              f" outputs {[tuple(g.shape) for g in got]} max |out| {lim} "
              f"mismatches {mism}", flush=True)
        bad += mism
        del args, got, want
    if bad:
        raise RuntimeError(f"{bad} w4a4/head kernel outputs differ from plain")
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 27
    phase(f"27 w4a4 graphs: f={F}, {NC} classes, {HW}x{HW}, batch 8")
    imgs = torch.tensor(
        np.random.default_rng(SEED + 2).standard_normal((8, HW, HW, 1)),
        dtype=torch.float32, device=dev)
    with torch.inference_mode():
        x = preprocess(imgs)
        lab8 = unet_psrp_forward(q8, x, NC)
        ref8 = tq.unet_int8_forward(tq.quantize_unet(layers, taps),
                                    x).argmax(-1)
        ref32 = tq.folded_forward(layers, x).argmax(-1)
        for mode, qp in qps.items():
            reset()
            lab = unet_psrp_forward(qp, x, NC)
            torch.cuda.synchronize()
            launched = counts()
            plain = unet_psrp_forward(qp, x, NC, reference=True)
            torch.cuda.synchronize()
            mism = int((lab != plain).sum())
            hist = torch.bincount(lab.flatten().long(), minlength=NC).tolist()
            print(f"{mode}: kernel graph vs plain graph {mism} label "
                  f"mismatches; agreement vs the all-int8 oracle "
                  f"{float((lab.long() == ref8).float().mean()):.6f}, vs "
                  f"float {float((lab.long() == ref32).float().mean()):.6f},"
                  f" vs the int8 PSRP graph "
                  f"{float((lab == lab8).float().mean()):.6f}; classes "
                  f"{hist}; launches {launched}, expected "
                  f"{LAUNCHES_PER_FORWARD}", flush=True)
            if mism or launched != LAUNCHES_PER_FORWARD:
                raise RuntimeError(f"w4a4 graph check failed ({mode})")
            del lab, plain
    del ref8, ref32
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 28
    phase(f"28 fused head (f={F}, {HW}x{HW}, batch 8): int8 and w4a4")
    head_launches = dict(LAUNCHES_PER_FORWARD, head_argmax=0)
    fused_counts = None
    with torch.inference_mode():
        for mode, qp in (("int8", q8), ("w4a4", qps["w4a4"])):
            unfused = unet_psrp_forward(qp, x, NC, head_fuse=False)
            reset()
            fused = unet_psrp_forward(qp, x, NC, head_fuse=True)
            torch.cuda.synchronize()
            launched = counts()
            fused_counts = fused_counts or launched
            mism = int((fused != unfused).sum())
            print(f"{mode}: fused-head labels vs unfused {mism} mismatches; "
                  f"launches {launched}, expected {head_launches}",
                  flush=True)
            if mism or launched != head_launches:
                raise RuntimeError(f"fused-head graph check failed ({mode})")
            del unfused, fused
    del x, imgs

    # ------------------------------------------------------------------ 29
    phase(f"29 cli infer / eval / serve --quantize int4 ({HW}x{HW})")
    common = ["--image-size", str(HW), "--num-classes", str(NC),
              "--batch-size", str(INFER_BATCH), "--device", "cuda",
              "--seed", str(SEED)]
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "int4.npz")
        masks = {}
        for label, argv in (
            ("int4 --save-quantized", ["--save-quantized", art]),
            ("int4 --load-quantized", ["--load-quantized", art]),
        ):
            out = os.path.join(tmp, label.split()[-1])
            reset()
            t0 = time.perf_counter()
            cli.main(["infer", *common, "--out-dir", out, "--quantize",
                      "int4", *argv])
            torch.cuda.synchronize()
            m = np.load(os.path.join(out, "masks.npy"), allow_pickle=False)
            print(f"cli infer {label}: masks {m.shape}, classes "
                  f"{np.bincount(m.ravel(), minlength=NC).tolist()}, "
                  f"{time.perf_counter() - t0:.2f} s, launches {counts()}",
                  flush=True)
            if m.shape != (INFER_BATCH, HW, HW) or m.min() < 0 \
                    or m.max() >= NC:
                raise RuntimeError(f"cli infer {label}: bad masks")
            masks[label] = m
        same = np.array_equal(*masks.values())
        print(f"--save-quantized then --load-quantized: identical masks "
              f"{same}")
        if not same:
            raise RuntimeError("the int4 artifact changed the masks")
    t0 = time.perf_counter()
    ev = cli.main(["eval", *common[:4], "--batch-size", "8", *common[6:],
                   "--quantize", "int4", "--num-val", "8"])
    total = int(ev["confusion"].sum())
    print(f"cli eval --quantize int4 --num-val 8: pixel accuracy "
          f"{ev['pixel_accuracy']:.4f}, confusion sum {total} (pixels "
          f"{8 * HW * HW}), {time.perf_counter() - t0:.2f} s", flush=True)
    if total != 8 * HW * HW:
        raise RuntimeError("cli eval --quantize int4 check failed")
    # serve: the int4 graph built as ``cli serve --quantize int4`` builds
    # it, behind the ServingLoop and HTTP; the run that the kernels line's
    # w4a4 launch counts come from
    forward, _ = cli.build_quantized_forward(model, "unet", "int4",
                                             image_size=HW, device=dev,
                                             seed=SEED)
    reqs = np.random.default_rng(SEED + 4).uniform(
        0, 255, (6, HW, HW, 1)).astype(np.float32)
    with torch.inference_mode():
        direct = forward(torch.from_numpy(reqs).to(dev)).cpu().numpy()
    loop = ServingLoop(forward, (HW, HW, 1), device=dev, batch_size=8,
                       max_wait_ms=5.0)
    reset()
    loop.warmup()
    httpd, _ = start_in_background(loop, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        got = [http_post(url, reqs[i]) for i in range(4)] \
            + [http_post(url, reqs[4:6])]
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.close()
    serve_launches = counts()
    want = [direct[i] for i in range(4)] + [direct[4:6]]
    ok = sum(np.array_equal(g, w) for g, w in zip(got, want))
    n_fwd = loop.batches_run + 1
    print(f"serve --quantize int4: {ok}/5 responses equal the direct "
          f"forward; launches {serve_launches}, expected {n_fwd} x "
          f"{LAUNCHES_PER_FORWARD}", flush=True)
    if ok != 5 or any(serve_launches[k] != n_fwd * v
                      for k, v in LAUNCHES_PER_FORWARD.items()):
        raise RuntimeError("int4 serving check failed")
    del forward, loop

    # ------------------------------------------------------------------ 30
    phase(f"30 w4a4 and fused-head times on {card}")
    qp4 = qps["w4a4"]
    del qps
    torch.cuda.empty_cache()
    rows = {}  # entry -> {"ms", "plain_ms", "dev_ms", "operations", "bytes"}
    by_row = {}  # TPU row -> [stages, ms, dev ms, plain ms, bound ms]
    for name, kernel, shape in stages():
        if kernel == "head_argmax" or not w4a4_stage(qp4, layer_name(name)):
            continue
        kernel, args, kw = stage_call(qp4, name, kernel, shape, 32)
        with torch.inference_mode():
            ms = time_ms(lambda: wrappers[kernel](*args, **kw))
            dms = device_ms(lambda: wrappers[kernel](*args, **kw))
            pms = time_ms(lambda: plains[kernel](*args, **kw), 3)
        b_ms, b_by = bound(*serving_work(kernel, shape, 32), PEAK["int8"])
        row = rows.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0,
                                       "dev_ms": 0.0, "operations": 0.0,
                                       "bytes": 0.0})
        for k, v in (("ms", ms), ("plain_ms", pms), ("dev_ms", dms),
                     (b_by, b_ms)):
            row[k] += v
        tr = by_row.setdefault(tpu_row(name, kernel, shape) + " w4a4",
                               [0, 0.0, 0.0, 0.0, 0.0])
        for i, v in enumerate((1, ms, dms, pms, b_ms)):
            tr[i] += v
        beside = ""
        if kernel == "ct2x2_int8":  # the int8 graph's call at this stage
            _, a8, kw8 = stage_call(q8, name, kernel, shape, 32)
            with torch.inference_mode():
                ms8 = time_ms(lambda: wrappers[kernel](*a8, **kw8))
                dms8 = device_ms(lambda: wrappers[kernel](*a8, **kw8))
            beside = f", int8 {ms8:.4f} ms (device {dms8:.4f})"
            del a8
        print(f"time b32 w4a4 {name:16s} {kernel:13s} kernel {ms:.4f} ms "
              f"(device {dms:.4f}){beside}, plain {pms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        del args
        torch.cuda.empty_cache()
    name, kernel, shape = blk8
    h, cins, cout, _ = shape
    for label, qp in (("int8", q8), ("w4a4", qp4)):
        kernel, args, kw = stage_call(qp, name, kernel, shape, 32, head=True)
        hd = kw.pop("head")
        with torch.inference_mode():
            ms = time_ms(lambda: k12.conv3x3_int8(*args, head=hd, **kw))
            dms = device_ms(lambda: k12.conv3x3_int8(*args, head=hd, **kw))
            pms = time_ms(lambda: k12.conv3x3_int8_reference(
                *args, head=hd, **kw), 3)

            def unfused():
                return k3.head_argmax(k12.conv3x3_int8(*args, **kw), *hd)

            ums = time_ms(unfused)
            udms = device_ms(unfused)
        b_ms, b_by = bound(*head_work(h, sum(cins), cout, 32), PEAK["int8"])
        if label == "int8":
            rows["head"] = {"ms": ms, "plain_ms": pms, "dev_ms": dms,
                            "operations": 0.0, "bytes": 0.0}
            rows["head"][b_by] = b_ms
        print(f"time b32 {label} blk8_conv1 + head: fused K1 {ms:.4f} ms "
              f"(device {dms:.4f}), K1 then K3 {ums:.4f} ms (device "
              f"{udms:.4f}), plain {pms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        del args
    for key, (n_st, ms, dms, pms, b_ms) in sorted(by_row.items()):
        print(f"time b32 TPU kernel {key} ({n_st} launches per forward): "
              f"kernel {ms:.4f} ms (device {dms:.4f}), plain {pms:.4f} ms, "
              f"bound {b_ms:.4f} ms")
    # P3's counterpart: the int4 dot rate and the +-7 clip (perf/int4probe)
    # become K1 at the deep stages' widths on +-7 values against int8
    # values, and clip 7 against clip 127 on the same +-7 inputs
    for h, c in ((HW // 4, 4 * F), (HW // 8, 8 * F), (HW // 16, 16 * F)):
        xs = {"int8": i8((32, h, h, c)), "w4a4": i8((32, h, h, c), -7, 8)}
        wq = {"int8": i8((c, c, 3, 3)), "w4a4": i8((c, c, 3, 3), -7, 8)}
        ws = {k: k12.pack_conv3x3_weights(v) for k, v in wq.items()}
        wm = {k: k12.pack_conv3x3_mma_weights(v) for k, v in wq.items()}
        sc = torch.full((c,), 1e-4, device=dev)
        bi = torch.zeros(c, device=dev)
        t = {}
        with torch.inference_mode():  # in turns, three rounds
            for _ in range(3):
                for label, v, clip in (("int8", "int8", 127.0),
                                       ("w4a4 clip 7", "w4a4", 7.0),
                                       ("w4a4 clip 127", "w4a4", 127.0)):
                    t.setdefault(label, []).append(device_ms(
                        lambda: k12.conv3x3_int8((xs[v],), ws[v], sc, bi,
                                                 out_clip=clip,
                                                 w_mma=wm[v])))
        ops = 2 * 32 * h * h * 9 * c * c
        print(f"time b32 P3 K1 {h}^2 x {c} -> {c} (device, profiler, "
              f"three rounds): " + ", ".join(
                  f"{k} {' / '.join(f'{x:.4f}' for x in v)} ms (median "
                  f"{ops / statistics.median(v) / 1e9:.1f} TOPS)"
                  for k, v in t.items()), flush=True)
        del xs, ws, wm
    torch.cuda.empty_cache()
    graphs = (("int8", lambda b: unet_psrp_forward(q8, preprocess(b), NC)),
              ("w4a4", lambda b: unet_psrp_forward(qp4, preprocess(b), NC)),
              ("int8 fused head", lambda b: unet_psrp_forward(
                  q8, preprocess(b), NC, head_fuse=True)))
    for nb in (32, 128):
        xb = torch.tensor(
            np.random.default_rng(nb).uniform(0, 255, (nb, HW, HW, 1)),
            dtype=torch.float32, device=dev)
        # in turns: int8, w4a4, fused, fused, w4a4, int8
        for label, fn in graphs + graphs[::-1]:
            with torch.inference_mode():
                ms = time_ms(lambda: fn(xb))
            print(f"forward ({label}, z-score + graph) batch {nb}: "
                  f"{ms:.3f} ms, {nb / ms * 1e3:.1f} B-scans/s", flush=True)
        del xb
        torch.cuda.empty_cache()

    def entry(name, kernel, row, launches, err, what):
        return {
            "name": name, "route": "cuda", "source": SOURCES[kernel],
            "replaces": what, "launches": launches, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["operations"] + row["bytes"],
            "bound_by": ("operations" if row["operations"] >= row["bytes"]
                         else "bytes"),
            # no single PyTorch call computes an int8 conv (or transposed
            # conv) with requant, or one ending in a head and argmax
            "library_ms": None,
        }

    return [
        entry("conv3x3_int8 w4a4", "conv3x3_int8", rows["conv3x3_int8"],
              serve_launches["conv3x3_int8"], max_err["conv3x3_int8"],
              REPLACES["conv3x3_int8"][0] + " (w4a4 knobs); "
              + REPLACES["conv3x3_int8"][2] + " (w4a4 knobs)"),
        entry("ct2x2_int8 w4a4", "ct2x2_int8", rows["ct2x2_int8"],
              serve_launches["ct2x2_int8"], max_err["ct2x2_int8"],
              REPLACES["ct2x2_int8"][0] + " (w4a4 knobs)"),
        entry("conv3x3_int8 fused head", "conv3x3_int8", rows["head"],
              fused_counts["conv3x3_int8"], max_err["head"],
              REPLACES["conv3x3_int8"][0] + " (head=)"),
    ]


DUKE_VOLUMES = 4  # synthetic Duke DME volumes written in phase 31
DUKE_SHAPE = (496, 768, 61)  # their (H, W, B-scans), the published size
RETOUCH_SHAPE = (49, 496, 512)  # a Spectralis case (B-scans, H, W)
SERVE_REQUESTS = 4  # HTTP requests per served mode in phase 31


def cpu_scored(evaluate, argv, main):
    """Run ``main(argv)`` (a ``cli eval``) with ``evaluate`` (the
    ``Trainer.evaluate`` it calls) keeping the labels and masks it scores;
    -> (the metrics ``main`` returned, [(labels, masks)] on the CPU)."""
    from types import SimpleNamespace

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        Trainer,
    )

    seen = []

    def keeping(self, state, dataset, *a, predict_fn=None, **kw):
        def epoch(e):
            for images, labels in dataset.epoch(e):
                seen.append([labels.cpu()])
                yield images, labels

        def predict(st, images):
            p = predict_fn(st, images)
            seen[-1].append(p.cpu())
            return p

        return evaluate(self, state, SimpleNamespace(epoch=epoch), *a,
                        predict_fn=predict, **kw)

    with swapped(Trainer, evaluate=keeping):
        m = main(argv)
    return m, seen


def real_data_phase(dev, card):
    """Phase 31: the real-data path on Duke-layout volumes (train --data,
    eval --data), preprocessing with flattening on the card, the RETOUCH
    readers, serve off / int8 / an artifact, and the metric families on
    CUDA tensors."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    import scipy.io as sio
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
        cli,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
        metrics,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.http_server import (
        start_in_background,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.metrics import (
        biomarker,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_bf16 as k45,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        head_argmax as k3,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        preprocess as pre,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        native_io,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        retouch,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.data import (
        load_real_dataset,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.duke import (
        synthetic_duke_dme_volume,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        Trainer,
    )

    phase(f"31 real-data path: {DUKE_VOLUMES} Duke DME v5 volumes, cli "
          f"train --data --packed and eval --data --quantize psrp ({HW}x{HW}"
          f"), preprocess, RETOUCH readers, serve, metrics, on {card}")
    wrappers = {"conv3x3_bf16": k45.conv3x3_bf16_fwd,
                "conv3x3_bf16_wgrad": k45.conv3x3_bf16_wgrad,
                "bn_pair_sums": k6.pair_sums,
                "conv3x3_int8": k12.conv3x3_int8,
                "ct2x2_int8": k12.ct2x2_int8, "pool2x2_int8": k12.pool2x2_int8,
                "head_argmax": k3.head_argmax,
                "stem_conv_int8": k10.stem_conv_int8}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def launched():
        return {k: w.launches for k, w in wrappers.items() if w.launches}

    def need(counts, names, what):
        missing = [k for k in names if not counts.get(k)]
        if missing:
            raise RuntimeError(f"{what}: {missing} not launched ({counts})")

    def step(name, t0):
        print(f"  {name}: {time.perf_counter() - t0:.2f} s ({card})",
              flush=True)

    found = []
    for name in ("cv2", "PIL", "h5py"):
        try:
            found.append(f"{name} {__import__(name).__version__}")
        except ImportError:
            found.append(f"{name} not installed")
    print(f"  image and HDF5 readers: {', '.join(found)}", flush=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        duke = os.path.join(tmp, "duke")
        os.makedirs(duke)
        t0 = time.perf_counter()

        def write_volume(i):
            rng = np.random.default_rng([SEED, 31, i])
            sio.savemat(os.path.join(duke, f"Subject_{i + 1:02d}.mat"),
                        synthetic_duke_dme_volume(rng, *DUKE_SHAPE))

        # numpy and the file writes release the GIL: one thread a volume
        with ThreadPoolExecutor(DUKE_VOLUMES) as pool:
            list(pool.map(write_volume, range(DUKE_VOLUMES)))
        step(f"write {DUKE_VOLUMES} volumes ({DUKE_SHAPE} uint8, 11 "
             "annotated B-scans, manualLayers1, manualFluid1)", t0)
        spec = f"duke:{duke}"
        common = ["--image-size", str(HW), "--batch-size", str(TRAIN_BATCH),
                  "--device", dev.type]
        width = ["--model-kwargs", json.dumps({"init_features": F})]

        # train --data --packed: K4, K5, K6
        t0 = time.perf_counter()
        reset()
        log = os.path.join(tmp, "train.jsonl")
        ckpt_dir = os.path.join(tmp, "ckpt")
        state = cli.main(["train", "--data", spec, "--packed", "--epochs",
                          "1", "--log-file", log, "--checkpoint-dir",
                          ckpt_dir, *common, *width])
        torch.cuda.synchronize()
        train_counts = launched()
        step("cli train --data --packed, one epoch (data read included)",
             t0)
        with open(log) as f:
            rec = json.loads(f.readline())
        print(f"  train: {state.step} steps, train loss "
              f"{rec['train_loss']:.4f}, validation loss "
              f"{rec['val_loss']:.4f}, launches {train_counts}", flush=True)
        need(train_counts, ("conv3x3_bf16", "conv3x3_bf16_wgrad",
                            "bn_pair_sums"), "train --data")
        if state.step < 1 or not (math.isfinite(rec["train_loss"])
                                  and math.isfinite(rec["val_loss"])):
            raise RuntimeError("train --data: no step or a loss not finite")
        # eval reads the file that train --checkpoint-dir wrote
        ckpt = os.path.join(ckpt_dir, "ckpt_0.pt")
        if sorted(os.listdir(ckpt_dir)) != ["ckpt_0.pt"]:
            raise RuntimeError(f"train --checkpoint-dir wrote "
                               f"{os.listdir(ckpt_dir)}")
        del state
        torch.cuda.empty_cache()

        # eval --data --quantize psrp from the trained weights, the masks
        # scored again on the CPU
        t0 = time.perf_counter()
        reset()
        m, seen = cpu_scored(Trainer.evaluate, [
            "eval", "--data", spec, "--quantize", "psrp", *common, *width,
            "--checkpoint", ckpt], cli.main)
        torch.cuda.synchronize()
        eval_counts = launched()
        step("cli eval --data --quantize psrp (data read included)", t0)
        need(eval_counts, ("conv3x3_int8", "ct2x2_int8", "head_argmax"),
             "eval --data")
        cpu_trainer, _ = cli.build_eval_trainer(cli.parser().parse_args(
            ["eval", "--num-classes", str(NC), "--device", "cpu"]))
        cpu = cpu_trainer.evaluate(
            None, SimpleNamespace(epoch=lambda e: iter(
                [(p, lab) for lab, p in seen])),
            predict_fn=lambda s, p: p)
        n_pix = sum(lab.numel() for lab, _ in seen)
        worst = max(float(np.nanmax(np.abs(
            np.asarray(m[k], np.float64) - np.asarray(cpu[k], np.float64))))
            for k in m if k != "confusion")
        nan_same = all(np.array_equal(np.isnan(np.asarray(m[k], float)),
                                      np.isnan(np.asarray(cpu[k], float)))
                       for k in m)
        print(f"  eval: {len(seen)} batch(es) of the validation split, "
              f"launches {eval_counts}; pixel accuracy "
              f"{m['pixel_accuracy']:.4f}, Dice {np.round(m['dice'], 4)}; "
              f"confusion sum {int(m['confusion'].sum())} (pixels {n_pix}),"
              f" equal to the CPU's "
              f"{np.array_equal(m['confusion'], cpu['confusion'])}; largest "
              f"metric difference from the CPU {worst:.3e} (limit 1e-4), "
              f"NaNs in the same places {nan_same}", flush=True)
        if int(m["confusion"].sum()) != n_pix or not worst <= 1e-4 \
                or not nan_same \
                or not np.array_equal(m["confusion"], cpu["confusion"]):
            raise RuntimeError("eval --data check failed")
        labels_b = seen[0][0]
        del cpu_trainer, seen

        # preprocess(flatten, denoise) on the card against the CPU
        t0 = time.perf_counter()
        one = os.path.join(tmp, "one_volume")
        os.makedirs(one)
        os.symlink(os.path.join(duke, "Subject_01.mat"),
                   os.path.join(one, "Subject_01.mat"))
        images = torch.from_numpy(load_real_dataset(
            f"duke:{one}", (HW, HW))[0][:TRAIN_BATCH]) * 255.0
        step("read one volume's annotated B-scans", t0)
        t0 = time.perf_counter()
        with torch.inference_mode():
            s_gpu = pre.estimate_surface(images.to(dev)).cpu()
            x_gpu = pre.preprocess(images.to(dev), flatten=True,
                                   denoise=True).cpu()
        torch.cuda.synchronize()
        s_cpu = pre.estimate_surface(images)
        x_cpu = pre.preprocess(images, flatten=True, denoise=True)
        diff = float((x_gpu - x_cpu).abs().max())
        same_s = torch.equal(s_gpu, s_cpu)
        step("preprocess(flatten=True, denoise=True), card and CPU", t0)
        print(f"  preprocess {tuple(images.shape)}: surfaces equal {same_s} "
              f"(rows {int(s_cpu.min())}-{int(s_cpu.max())}), largest "
              f"difference {diff:.3e} (limit 1e-5)", flush=True)
        if not same_s or not diff <= 1e-5:
            raise RuntimeError("preprocess on the card differs from the CPU")
        del images, x_gpu, x_cpu

        # RETOUCH: a 49 x 496 x 512 uint16 zlib case, the Python reader
        # against the native reader and prefetch pool
        t0 = time.perf_counter()
        case = os.path.join(tmp, "retouch", "TRAIN001")
        os.makedirs(case)
        r = np.random.default_rng(SEED + 32)
        vol = r.gamma(4.0, 2000.0, RETOUCH_SHAPE).clip(0, 65535)
        vol = vol.astype(np.uint16)
        ref = np.zeros(vol.shape, np.uint8)
        ref[:, 20:60, 10:30] = r.integers(1, 4)
        paths = [os.path.join(case, n) for n in ("oct.mhd",
                                                 "reference.mhd")]
        retouch.write_mhd_volume(paths[0], vol, compressed=True)
        retouch.write_mhd_volume(paths[1], ref, compressed=True)
        step(f"write a RETOUCH case ({RETOUCH_SHAPE} uint16 + labels, "
             "zlib)", t0)
        t0 = time.perf_counter()
        py = [retouch.load_mhd_volume(p)[0] for p in paths]
        step("read it with load_mhd_volume", t0)
        t0 = time.perf_counter()
        with native_io.PrefetchReader(paths, n_threads=2) as reader:
            nat = list(reader)
        step("read it with the native PrefetchReader (g++ build included)",
             t0)
        same = (len(nat) == 2 and all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(nat, py)) and np.array_equal(py[0], vol)
            and np.array_equal(py[1], ref))
        print(f"  RETOUCH: arrays equal {same} ({vol.shape} {vol.dtype}, "
              f"{ref.shape} {ref.dtype})", flush=True)
        if not same:
            raise RuntimeError("the RETOUCH readers differ")
        del vol, ref, py, nat

        # serve: int8, off, and psrp from an artifact, built as cli serve
        # builds them, each response against the direct forward
        art = os.path.join(tmp, "psrp.npz")
        cli.main(["infer", "--quantize", "psrp", "--checkpoint", ckpt,
                  "--save-quantized", art, "--out-dir",
                  os.path.join(tmp, "infer"), *common, *width])
        model = cli.build_model(num_classes=NC, init_features=F, seed=SEED,
                                checkpoint=ckpt, device=dev)
        reqs = np.random.default_rng(SEED + 33).uniform(
            0, 255, (SERVE_REQUESTS, HW, HW, 1)).astype(np.float32)
        for mode, extra in (("int8", []), ("off", []),
                            ("psrp", ["--load-quantized", art])):
            t0 = time.perf_counter()
            if mode == "off":
                direct_fwd = cli.build_float_forward(model, "bfloat16")
            else:
                direct_fwd = cli.build_quantized_forward(
                    model, "unet", mode, image_size=HW, device=dev,
                    seed=SEED)[0]
            want = []
            with torch.inference_mode():
                for i in range(SERVE_REQUESTS):
                    # alone in a zero-padded batch, as the loop serves it
                    pad = np.zeros((TRAIN_BATCH, HW, HW, 1), np.float32)
                    pad[0] = reqs[i]
                    want.append(direct_fwd(torch.from_numpy(pad).to(dev))
                                [0].cpu().numpy())
            loop = cli.build_serving(cli.parser().parse_args(
                ["serve", "--quantize", mode, "--checkpoint", ckpt,
                 "--init-features", str(F), "--image-size", str(HW),
                 "--device", dev.type, "--batch-size", str(TRAIN_BATCH),
                 *extra]))
            reset()
            loop.warmup()
            httpd, _ = start_in_background(loop, port=0)
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                got = [http_post(url, reqs[i])
                       for i in range(SERVE_REQUESTS)]
            finally:
                httpd.shutdown()
                httpd.server_close()
                loop.close()
            counts = launched()
            ok = sum(np.array_equal(g, w) for g, w in zip(got, want))
            step(f"serve --quantize {mode}{' --load-quantized' * bool(extra)}"
                 f": {ok}/{SERVE_REQUESTS} responses equal the direct "
                 f"forward, launches {counts}", t0)
            if ok != SERVE_REQUESTS:
                raise RuntimeError(f"serve --quantize {mode}: labels differ")
            if mode == "psrp":
                need(counts, ("conv3x3_int8", "ct2x2_int8", "head_argmax"),
                     "serve --load-quantized")
            del loop, direct_fwd

        # infer --image-dir, where an image reader is installed
        try:
            from PIL import Image

            def write_png(path, img):
                Image.fromarray(img).save(path)
        except ImportError:
            try:
                import cv2

                def write_png(path, img):
                    cv2.imwrite(path, img)
            except ImportError:
                write_png = None
        if write_png is None:
            print("  infer --image-dir: not driven (neither PIL nor cv2 is "
                  "installed)", flush=True)
        else:
            t0 = time.perf_counter()
            folder = os.path.join(tmp, "bscans")
            os.makedirs(folder)
            grey = np.random.default_rng(SEED + 35).integers(
                0, 256, (SERVE_REQUESTS, HW, HW), dtype=np.uint8)
            for i, img in enumerate(grey):
                write_png(os.path.join(folder, f"bscan_{i:03d}.png"), img)
            out = os.path.join(tmp, "infer_dir")
            reset()
            cli.main(["infer", "--image-dir", folder, "--quantize", "psrp",
                      "--checkpoint", ckpt, "--out-dir", out, *common,
                      *width])
            counts = launched()
            masks = np.load(os.path.join(out, "masks.npy"))
            with torch.inference_mode():
                want = cli.build_quantized_forward(
                    model, "unet", "psrp", image_size=HW, device=dev,
                    seed=SEED)[0](torch.from_numpy(
                        grey[..., None].astype(np.float32)).to(dev))
            same = np.array_equal(masks, want.cpu().numpy())
            step(f"cli infer --image-dir ({SERVE_REQUESTS} PNGs, psrp): "
                 f"masks {masks.shape} equal the direct forward {same}, "
                 f"launches {counts}", t0)
            if not same:
                raise RuntimeError("infer --image-dir: masks differ")
            need(counts, ("conv3x3_int8", "ct2x2_int8", "head_argmax"),
                 "infer --image-dir")
        del model
        torch.cuda.empty_cache()

    # the metric families on CUDA tensors against the CPU: one class of
    # two B-scans' labels (the one-epoch model's masks are near-constant)
    t0 = time.perf_counter()
    worst = {}
    cls = 1 + int(torch.bincount(labels_b[0].flatten(), minlength=NC)[1:]
                  .argmax())
    yt_c = (labels_b[0] == cls).to(torch.int32)
    yp_c = (labels_b[1] == cls).to(torch.int32)
    scores = yp_c.float() * 0.5 + torch.from_numpy(np.random.default_rng(
        SEED + 34).random(yp_c.shape).astype(np.float32))
    pair = ["accuracy", "sensitivity", "cm_precision", "specificity",
            "dice_coefficient", "iou_score", "precision", "recall",
            "mean_squared_error", "root_mean_squared_error",
            "thickness_difference", "vascularity_index", "mad",
            "hausdorff_distance", "hausdorff_distance_95", "assd"]
    for name in pair:
        g = float(getattr(metrics, name)(yt_c.to(dev), yp_c.to(dev)))
        c = float(getattr(metrics, name)(yt_c, yp_c))
        worst[name] = abs(g - c)
    g = float(metrics.auc_score(yt_c.to(dev), scores.to(dev)))
    worst["auc_score"] = abs(g - float(metrics.auc_score(yt_c, scores)))
    counts_same = [float(a) for a in metrics.confusion_counts(
        yt_c.to(dev), yp_c.to(dev))] == [float(a) for a in
                                          metrics.confusion_counts(yt_c,
                                                                   yp_c)]
    tmap = float((biomarker.thickness_map(yt_c.to(dev)).cpu()
                  - biomarker.thickness_map(yt_c)).abs().max())
    worst["thickness_map"] = tmap
    step(f"metric families, class {cls} of two B-scans ({HW}x{HW}), card "
         "and CPU", t0)
    top = max(worst, key=worst.get)
    print(f"  metrics: confusion counts equal {counts_same}; largest "
          f"difference {worst[top]:.3e} ({top}; limit 1e-4); "
          f"{len(worst)} functions", flush=True)
    if not counts_same or worst[top] > 1e-4:
        raise RuntimeError("metrics on the card differ from the CPU")
    print(f"phase 31: {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)


ZOO_BATCH = 8  # Y-Net and Y-Net-FFC: forward and train batch (phase 32)
ZOO_STEPS = 4  # Trainer steps in phase 32's one-epoch runs
EDGEAL_NC, EDGEAL_BATCH = 3, 4
FOURIER_IMAGES, FOURIER_BATCH = 8, 4
ANOGAN_HW, ANOGAN_BATCH = 64, 64
# Y-Net-FFC's train-mode BatchNorms: the U-Net blocks' 18, the four
# spectral stages' two stream BNs and stages 2-4's three spectral BNs; K6
# runs twice for each (forward sums, backward sums)
YNET_FFC_K6_PER_STEP = 2 * (18 + 4 * 2 + 3 * 3)
YNET_K6_PER_STEP = 2 * 26


def _outputs(out):
    """The tensors of a model's output (a tensor, or a tuple or list of
    tensors and lists), in order."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _outputs(o)]


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def card_vs_cpu(dev, bad, label, cpu_model, x):
    """max |card - CPU| / max |CPU| over the eval forward's outputs,
    float32 with TF32 off on the card; above 1e-4 it joins ``bad``."""
    import copy

    import torch

    cpu_model.eval()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    with torch.no_grad():
        want = _outputs(cpu_model(x))
        model = copy.deepcopy(cpu_model).to(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            got = _outputs(model(x.to(dev)))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
    rel = max(float((g.cpu() - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    print(f"{label}: card vs CPU, eval forward {tuple(x.shape)}, TF32 "
          f"off: max |difference| / max |CPU| {rel:.3e} over "
          f"{len(want)} output(s) (limit 1e-4)", flush=True)
    if not rel <= 1e-4:
        bad.append(f"{label} card vs CPU {rel:.3e}")


def forward_time(dev, time_ms, label, model, batch, nc):
    """The eval forward's ms at ``batch`` under bf16 autocast (median of
    5)."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        nhwc_logits,
    )

    xb, _ = train_batch(dev, batch, SEED + 90, nc)
    model.eval()
    with torch.no_grad():
        ms = time_ms(lambda: nhwc_logits(model, xb, torch.bfloat16), 5)
    print(f"{label} forward, batch {batch}, bf16 autocast: {ms:.3f} ms "
          f"(median of 5), {batch / ms * 1e3:.1f} B-scans/s", flush=True)


def trainer_epoch(dev, bad, name, nc, batch, steps, kwargs=None):
    """One ``cli train`` epoch (Adam 1e-3, dice_ce, bf16 autocast) of
    ``steps`` steps on synthetic B-scans; K6 counted from 0. -> (trainer,
    state, K6 launches a step)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
        cli,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )

    args = cli.parser().parse_args([
        "train", "--model", name, "--image-size", str(HW),
        "--num-classes", str(nc), "--batch-size", str(batch),
        "--num-train", str(steps * batch), "--num-val", str(batch),
        "--epochs", "1", "--device", str(dev),
        "--model-kwargs", json.dumps(kwargs or {})])
    trainer, train_ds, val_ds = cli.build_training(args)
    k6.pair_sums.launches = 0
    t0 = time.perf_counter()
    state = trainer.fit(train_ds, val_ds)
    _sync(dev)
    launches = k6.pair_sums.launches
    rec = trainer.history[0]
    print(f"{name}: cli train, one epoch of {steps} steps at batch "
          f"{batch} in {time.perf_counter() - t0:.2f} s (validation "
          f"included): train loss {rec['train_loss']:.6f}, val loss "
          f"{rec['val_loss']:.6f}; K6 launches {launches} "
          f"({launches / steps:g} a step)", flush=True)
    if not (math.isfinite(rec["train_loss"])
            and math.isfinite(rec["val_loss"])):
        bad.append(f"{name} losses {rec}")
    if dev.type == "cuda" and launches == 0:
        bad.append(f"{name}: K6 not launched by the train steps")
    return trainer, state, launches / steps


def step_times(dev, label, trainer, state, batch, nc, host=False):
    """ms per train step (host clock over 5 after 2), peak memory and a
    profile with K6's kernels a step and the idle share; with ``host``,
    the profile's host side. -> the step's (images, labels)."""
    import torch

    images, labels = train_batch(dev, batch, SEED + 92, nc)
    step = trainer.train_step_fn()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, images, labels)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        step(state, images, labels)
    _sync(dev)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if on_card else "not measured")
    print(f"{label} train step, batch {batch}: {ms:.3f} ms, "
          f"{batch / ms * 1e3:.1f} B-scans/s, peak memory {peak}",
          flush=True)
    if on_card:
        profile_breakdown(lambda: step(state, images, labels), 3,
                          f"{label} train steps at batch {batch}",
                          {"K6 bn_pair_sums": "pair_sums"}, host=host)
    return images, labels

def zoo_phase(dev, card, time_ms):
    """Phase 32: the zoo's first models on the FFC stack (Y-Net-FFC, Y-Net,
    EdgeAL), FourierNet with its FD targets and trainer, and AnoGAN with
    its adversarial step, at the JAX defaults' full width from seed
    ``SEED``; K6 in every train-mode BatchNorm."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
        get_model,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.adversarial import (
        AnoGANTrainer,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.fouriernet_pipeline import (
        FourierNetTrainer,
        prepare_dataset,
    )

    on_card = dev.type == "cuda"
    phase(f"32 the zoo's first models: Y-Net-FFC, Y-Net, EdgeAL, "
          f"FourierNet, AnoGAN ({HW}x{HW}, full width, seed {SEED}) on "
          f"{card}")
    bad = []

    # --------------------------------------------------------- Y-Net-FFC
    nc = NC
    side = min(128, HW)
    xs, _ = train_batch(dev, 2, SEED + 93, nc)
    xs = xs[:, :side, :side].permute(0, 3, 1, 2).contiguous().cpu()
    for name in ("y_net_gen_ffc", "y_net_gen"):
        label = {"y_net_gen_ffc": "Y-Net-FFC", "y_net_gen": "Y-Net"}[name]
        cpu_model = get_model(name, num_classes=nc, seed=SEED)
        print(f"{label} (f=32, ratio 0.5, {nc} classes): "
              f"{sum(p.numel() for p in cpu_model.parameters()):,} "
              f"parameters", flush=True)
        card_vs_cpu(dev, bad, label, cpu_model, xs)
        forward_time(dev, time_ms, label, cpu_model.to(dev), ZOO_BATCH,
                     nc)
        del cpu_model
        trainer, state, per_step = trainer_epoch(dev, bad, name, nc,
                                                 ZOO_BATCH, ZOO_STEPS)
        want = (YNET_FFC_K6_PER_STEP if name == "y_net_gen_ffc"
                else YNET_K6_PER_STEP)
        if on_card and per_step != want:
            bad.append(f"{label}: K6 {per_step:g} a step, expected {want}")
        images, labels = step_times(dev, label, trainer, state, ZOO_BATCH,
                                    nc)
        if name == "y_net_gen_ffc":
            k6_gate(label, trainer, images, labels, k6, bad, on_card)
        del trainer, state, images, labels
        if on_card:
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ EdgeAL
    cpu_model = get_model("edgeal", in_channels=1, num_classes=EDGEAL_NC,
                          seed=SEED)
    print(f"EdgeAL (ngf 64, 9 blocks, 3 downsamplings, {EDGEAL_NC} "
          f"classes): {sum(p.numel() for p in cpu_model.parameters()):,} "
          f"parameters", flush=True)
    card_vs_cpu(dev, bad, "EdgeAL", cpu_model,
                xs[:, :, :64, :64].contiguous())
    forward_time(dev, time_ms, "EdgeAL", cpu_model.to(dev), EDGEAL_BATCH,
                 EDGEAL_NC)
    del cpu_model
    trainer, state, _ = trainer_epoch(dev, bad, "edgeal", EDGEAL_NC,
                                      EDGEAL_BATCH, 1)
    step_times(dev, "EdgeAL", trainer, state, EDGEAL_BATCH, EDGEAL_NC,
               host=True)
    del trainer, state
    if on_card:
        torch.cuda.empty_cache()

    # -------------------------------------------------------- FourierNet
    images, labels = train_batch(dev, FOURIER_IMAGES, SEED + 94, nc)
    images = images[..., 0].cpu().numpy()
    masks = (labels == 3).cpu().numpy().astype(np.uint8)  # one layer
    t0 = time.perf_counter()
    data = prepare_dataset(images, masks, fd_channel=1)
    print(f"FourierNet: prepare_dataset on {FOURIER_IMAGES} masks of "
          f"{HW}x{HW} in {time.perf_counter() - t0:.2f} s (host); FD "
          f"targets finite {bool(np.isfinite(data[1]).all())}", flush=True)
    fn = FourierNetTrainer(max_epochs=2, batch_size=FOURIER_BATCH,
                           seed=SEED, device=dev)
    k6.pair_sums.launches = 0
    t0 = time.perf_counter()
    best = fn.fit(data, tuple(a[:FOURIER_BATCH] for a in data))
    _sync(dev)
    print(f"FourierNetTrainer.fit, 2 epochs of "
          f"{FOURIER_IMAGES // FOURIER_BATCH} steps at batch "
          f"{FOURIER_BATCH} (Adadelta 0.01, dropout 0.2): "
          f"{time.perf_counter() - t0:.2f} s, history "
          f"{[(round(h['loss'], 6), round(h['val_loss'], 6)) for h in fn.history]}"
          f"; K6 launches {k6.pair_sums.launches} (FourierNet has no "
          f"BatchNorm)", flush=True)
    probs = fn.predict(best, data[0][:FOURIER_BATCH])
    ok = (probs.shape == (FOURIER_BATCH, HW, HW)
          and bool(np.isfinite(probs).all()) and probs.min() >= 0.0
          and probs.max() <= 1.0)
    print(f"FourierNet predict: class-1 probabilities {probs.shape}, in "
          f"[{probs.min():.4f}, {probs.max():.4f}]", flush=True)
    if not ok or not all(math.isfinite(h["loss"]) for h in fn.history):
        bad.append("FourierNet fit/predict")
    del fn, best
    cpu_model = get_model("fouriernet", seed=SEED)
    card_vs_cpu(dev, bad, "FourierNet", cpu_model, xs)
    del cpu_model

    # ------------------------------------------------------------ AnoGAN
    an = AnoGANTrainer(seed=SEED, device=dev)
    state = an.init()
    step = an.make_train_step()
    gx = torch.Generator(device=dev).manual_seed(SEED + 95)
    x = torch.rand((ANOGAN_BATCH, ANOGAN_HW, ANOGAN_HW, 1), generator=gx,
                   device=dev)
    k6.pair_sums.launches = 0
    t0 = time.perf_counter()
    losses = [{k: float(v) for k, v in step(state, x).items()}
              for _ in range(5)]
    _sync(dev)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    launches = k6.pair_sums.launches
    print(f"AnoGANTrainer: 5 steps at {ANOGAN_HW}x{ANOGAN_HW}, batch "
          f"{ANOGAN_BATCH}: {ms:.3f} ms a step (the first included); "
          f"losses {[{k: round(v, 5) for k, v in l.items()} for l in losses]}"
          f"; K6 launches {launches} ({launches / 5:g} a step)", flush=True)
    t0 = time.perf_counter()
    for _ in range(5):
        step(state, x)
    _sync(dev)
    print(f"AnoGANTrainer: 5 more steps, {(time.perf_counter() - t0) / 5 * 1e3:.3f} "
          f"ms a step", flush=True)
    if not all(math.isfinite(v) for l in losses for v in l.values()):
        bad.append(f"AnoGAN losses {losses}")
    if on_card and launches == 0:
        bad.append("AnoGAN: K6 not launched by the train steps")
    del an, state, x
    if bad:
        raise RuntimeError(f"phase 32: {bad}")
    if on_card:
        torch.cuda.empty_cache()


def k6_gate(label, trainer, images, labels, k6, bad, on_card):
    """The K6 gate on one float32 train step (TF32 off, cuDNN
    deterministic) of ``trainer``'s model from its trained state: K6
    against its plain version (``ZOO_K6_GATE``: relative loss and
    whole-gradient cosine), the same step twice (which must be
    bit-equal), and a planted K6 fault (sums 0.5% high) that must fail
    the limits. Beside them it prints the floor: the plain version with
    its sums one float32 ulp high, against the plain version."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        nhwc_logits,
    )

    model = trainer.model
    limits = ZOO_K6_GATE
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def loss_and_grads():
        model.load_state_dict(saved)
        model.train()
        model.zero_grad(set_to_none=True)
        loss = trainer.loss_fn(nhwc_logits(model, images, torch.float32),
                               labels, trainer.class_weights)
        loss.backward()
        if on_card:
            torch.cuda.synchronize()
        return float(loss.detach()), torch.cat([
            (torch.zeros_like(p) if p.grad is None else p.grad)
            .detach().double().flatten() for p in model.parameters()])

    def compare(a, b):
        return (abs(a[0] - b[0]) / abs(b[0]),
                float(a[1] @ b[1] / (a[1].norm() * b[1].norm())))

    def passes(c):
        return c[0] < limits["loss"] and c[1] > limits["cosine"]

    sums = k6.pair_sums

    def k6_sums_high(a, b=None):
        """K6 with its sums 0.5% high."""
        return sums(a, b) * 1.005

    def plain_one_ulp_high(a, b=None):
        s = k6.pair_sums_reference(a, b)
        return torch.nextafter(s, torch.full_like(s, math.inf))

    k6_sums_high.launches = 0  # the wrapper counts under its module name
    try:
        kern = loss_and_grads()
        again = loss_and_grads()
        with swapped(k6, pair_sums=k6.pair_sums_reference):
            ref = loss_and_grads()
        with swapped(k6, pair_sums=plain_one_ulp_high):
            floor = compare(loss_and_grads(), ref)
        with swapped(k6, pair_sums=k6_sums_high):
            fault = compare(loss_and_grads(), ref)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
        model.load_state_dict(saved)
    every = compare(kern, ref)
    same = kern[0] == again[0] and bool(torch.equal(kern[1], again[1]))
    print(f"{label} step from the trained state (float32, TF32 off, cuDNN "
          f"deterministic): K6 vs its plain version: relative loss "
          f"{every[0]:.3e}, whole-gradient cosine {every[1]:.9f}; the same "
          f"step twice: loss equal {kern[0] == again[0]}, gradients equal "
          f"{bool(torch.equal(kern[1], again[1]))}; floor (the plain "
          f"version's sums one ulp high): relative loss {floor[0]:.3e}, "
          f"cosine {floor[1]:.9f}; planted fault (K6 sums 0.5% high): "
          f"relative loss {fault[0]:.3e}, cosine {fault[1]:.9f}; gate "
          f"relative loss < {limits['loss']}, cosine > {limits['cosine']}, "
          f"bit-equal repeat", flush=True)
    if not passes(every):
        bad.append(f"{label}: K6 and its plain version disagree")
    if not same:
        bad.append(f"{label}: the same step twice is not bit-equal")
    if passes(fault):
        bad.append(f"{label}: the gate does not see a planted K6 fault")


def k6_odd_channels(dev, label, trainer, images, labels, k6, bad):
    """K6 against its plain version at every shape that one train step in
    the trainer's dtype gives a BatchNorm whose channels are not a
    multiple of 8 (K6's one-channel-a-lane path), in the dtype the kernel
    sees there, on seeded inputs around 1: relative error within 1e-6 and
    a second call bit-equal. The step is taken on a copy of the state,
    which is put back."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        nhwc_logits,
    )

    model = trainer.model
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sums, seen = k6.pair_sums, {}

    def record(a, b=None):
        if a.shape[-1] % 8:
            dtype = a.dtype if b is None or b.dtype == a.dtype \
                else torch.float32  # the wrapper's cast
            seen[(tuple(a.shape), dtype, b is not None)] = None
        return sums(a, b)

    record.launches = 0  # the wrapper counts under its module name
    try:
        with swapped(k6, pair_sums=record):
            model.train()
            trainer.loss_fn(nhwc_logits(model, images, trainer.dtype),
                            labels, trainer.class_weights).backward()
    finally:
        model.load_state_dict(saved)
        model.zero_grad(set_to_none=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 97)
    for shape, dtype, two in seen:
        a = (torch.randn(shape, generator=g, device=dev) + 1.0).to(dtype)
        b = ((torch.randn(shape, generator=g, device=dev) + 1.0).to(dtype)
             if two else None)
        got, again = k6.pair_sums(a, b), k6.pair_sums(a, b)
        want = k6.pair_sums_reference(a, b)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs()).max())
        same = torch.equal(got, again)
        print(f"{label}: K6 at {shape} {str(dtype)[6:]} "
              f"{'bwd' if two else 'fwd'} (plan {k6.launch_plan(a, b).text()}"
              f"): relative error {rel:.3e} (limit 1e-6), a second call "
              f"{'bit-equal' if same else 'DIFFERENT'}", flush=True)
        if not (rel <= 1e-6 and same):
            bad.append(f"{label}: K6 at {shape} {dtype} two={two}")
        del a, b, got, again, want
    if not seen:
        print(f"{label}: no BatchNorm with channels not a multiple of 8",
              flush=True)


# phase 33: (registry name, label, train batch, K6 launches a step: one
# forward and one backward launch per train-mode BatchNorm)
ZOO2 = (
    # 14 in the seven UnetConvs + 8 Basconvs in the MGR module
    ("mgunet", "MGU-Net", 8, 2 * (14 + 8)),
    ("mgunet_2", "MGU-Net-2", 8, 2 * (14 + 8)),
    # 2 stem + 15 in the five ResNetBlocks + 4 in ASPP(1024) + 30 in the
    # five DecoderBlocks + 4 in ASPP(27)
    ("islam", "ISLAM", 4, 2 * (2 + 15 + 4 + 30 + 4)),
    # 8 in the contracting blocks + 8 in SeparableDown + 2 in the
    # bottleneck + 1 at the head
    ("lightreseg", "LightReSeg", 4, 2 * (8 + 8 + 2 + 1)),
)
# the K6 gate (``k6_gate``: Y-Net-FFC in phase 32, ISLAM and LightReSeg in
# phase 33), on a float32 step with TF32 off, where the plain version's
# sums one ulp high move the loss by at most ~7e-8; in bf16 such an ulp
# flips roundings of the activations and moves it by 2e-6 to 1.3e-5,
# depending on the state (PERF.md section 6)
ZOO_K6_GATE = {"loss": 1e-6, "cosine": 0.99999}
# card against CPU (phase 33): (label, name, kwargs, side)
ZOO2_CARD_VS_CPU = (
    ("MGU-Net", "mgunet", {}, 160),
    ("MGU-Net, is_deconv=False", "mgunet", {"is_deconv": False}, 160),
    ("MGU-Net-2", "mgunet_2", {}, 128),
    ("ISLAM", "islam", {}, 128),
    ("ISLAM, multi-head + Gaussian", "islam",
     {"use_multi_head": True, "gaussian_output": True}, 128),
    ("LightReSeg, gamma 0.5", "lightreseg", {}, 128),
)


def zoo2_phase(dev, card, time_ms):
    """Phase 33: MGU-Net (both variants), ISLAM and LightReSeg at the JAX
    defaults' full width from seed ``SEED``: the eval forward on the card
    against the CPU, one ``cli train`` epoch each at 512^2 with K6 in every
    train-mode BatchNorm (its launches a step against the count above),
    the readings, and the K6 gate on ISLAM's and LightReSeg's steps (in
    float32, TF32 off)."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.lightreseg import (
        ChannelAttentionModule,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
        get_model,
    )

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    phase(f"33 MGU-Net (both variants), ISLAM, LightReSeg ({HW}x{HW}, full "
          f"width, seed {SEED}) on {card}")
    bad = []
    xs, _ = train_batch(dev, 2, SEED + 96)
    xs = xs.permute(0, 3, 1, 2).contiguous().cpu()
    for label, name, kw, side in ZOO2_CARD_VS_CPU:
        cpu_model = get_model(name, num_classes=NC, seed=SEED, **kw)
        for m in cpu_model.modules():
            if isinstance(m, ChannelAttentionModule):
                with torch.no_grad():  # zero at init: put it on the path
                    m.gamma.fill_(0.5)
        card_vs_cpu(dev, bad, label, cpu_model,
                    xs[:, :, :side, :side].contiguous())
    del cpu_model
    for name, label, batch, want in ZOO2:
        model = get_model(name, num_classes=NC, seed=SEED, device=dev)
        print(f"{label} ({NC} classes): "
              f"{sum(p.numel() for p in model.parameters()):,} parameters",
              flush=True)
        forward_time(dev, time_ms, label, model, ZOO_BATCH, NC)
        del model
        trainer, state, per_step = trainer_epoch(dev, bad, name, NC, batch,
                                                 ZOO_STEPS)
        if on_card and per_step != want:
            bad.append(f"{label}: K6 {per_step:g} a step, expected {want}")
        images, labels = step_times(dev, label, trainer, state, batch, NC)
        if on_card:
            k6_odd_channels(dev, label, trainer, images, labels, k6, bad)
        if name in ("islam", "lightreseg"):
            k6_gate(label, trainer, images, labels, k6, bad, on_card)
        del trainer, state, images, labels
        if on_card:
            torch.cuda.empty_cache()
    print(f"phase 33: {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    if bad:
        raise RuntimeError(f"phase 33: {bad}")


# phase 34: (registry name, label, train batch, K6 launches a step: one
# forward and one backward launch per train-mode BatchNorm)
ZOO3 = (
    # Res2Net-50: 3 in the stem, 5 in each of the 16 Bottle2necks and 4
    # downsamples; 22 ConvBRs
    ("msnet", "MSNet", 8, 2 * (87 + 22)),
    # and the two shared CNN1 filters, called 4 times in each of 10 units
    ("m2snet", "M2SNet", 8, 2 * (87 + 22 + 40)),
    ("watnet", "WAT-Net", 8, 2 * 20),  # 10 X2Convs x 2
    ("masood", "Masood", 8, 2 * 20),  # 4 CNNBranches x 5
    # 9 ConvStages x 2; its two full-size SDAs hold a (128^2)^2 float32
    # pixel attention, 1 GiB an image, and its softmax
    ("retifluidnet", "RetiFluidNet", 4, 2 * 18),
)
# BioNet (three outputs, no trainer in either package): one train-mode
# forward and backward in the phase; the two BioUNets' 28 BatchNorms and
# ResNet-18's 20
BIONET_K6_PER_STEP = 2 * (28 + 20)
# card against CPU (phase 34, 128^2): (label, name); RetiFluidNet apart
ZOO3_CARD_VS_CPU = (("MSNet", "msnet"), ("M2SNet", "m2snet"),
                    ("BioNet", "bionet"), ("WAT-Net", "watnet"),
                    ("Masood", "masood"))
ZOO3_SIDE = 128


def retifluid_off_saturation(model):
    """``model`` with its SDAs' 1x1 convs redrawn torch's default way
    (seed ``SEED + 1``) instead of the published 1.0: a conv of ones sums
    every channel into each, the features grow stage by stage, and at
    128^2 every probability of the model at its init is exactly 0 or 1,
    which no comparison can read."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.retifluidnet import (
        SDA,
    )

    g = torch.Generator().manual_seed(SEED + 1)
    for m in model.modules():
        if isinstance(m, SDA):
            for c in (m.pixel_conv, m.chan_conv):
                torch.nn.init.kaiming_uniform_(c.weight, a=math.sqrt(5),
                                               generator=g)
    return model


def retifluid_card_vs_cpu(dev, bad, cpu_model, x, nc):
    """RetiFluidNet's eval forward on the card against the CPU (float32,
    TF32 off): the 5 * nc probability channels within 1e-4 of the largest
    CPU output; the 40 bicon channels equal wherever the CPU's top two
    probabilities of the head each map comes from differ by more than
    1e-5 (an argmax at a near-tie may flip), the other pixels counted."""
    import copy

    import torch

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    with torch.no_grad():
        want = cpu_model.eval()(x)
        model = copy.deepcopy(cpu_model).to(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            got = model(x.to(dev)).cpu()
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
    n, _, h, w = want.shape
    rel = float((got[:, 40:] - want[:, 40:]).abs().max()
                / want[:, 40:].abs().max())
    # heads in bicon order: main, output1, output2, output3, output4
    probs = want[:, 40:].reshape(n, 5, nc, h, w)[:, [0, 4, 3, 2, 1]]
    top2 = probs.topk(2, dim=2).values
    clear = (top2[:, :, 0] - top2[:, :, 1]) > 1e-5  # (n, 5, h, w)
    g = got[:, :40].reshape(n, 5, 8, h, w)
    wb = want[:, :40].reshape(n, 5, 8, h, w)
    differ = int(((g != wb).any(dim=2) & clear).sum())
    inner = float(((want[:, 40:] > 1e-6) & (want[:, 40:] < 1 - 1e-6))
                  .float().mean())
    print(f"RetiFluidNet, SDA convs redrawn: card vs CPU, eval forward "
          f"{tuple(x.shape)}, TF32 off ({inner:.2%} of the CPU's "
          f"probabilities off 0 and 1): probabilities max |difference| / "
          f"max |CPU| {rel:.3e} "
          f"(limit 1e-4); bicon maps: {differ} pixels differ where the top "
          f"two probabilities are more than 1e-5 apart (limit 0), "
          f"{int((~clear).sum())} of {clear.numel()} head pixels at a "
          f"near-tie not compared", flush=True)
    if not rel <= 1e-4 or differ:
        bad.append(f"RetiFluidNet card vs CPU {rel:.3e}, bicon {differ}")


def glcm_card_vs_cpu(dev, bad):
    """Masood's GLCM features of a batch of 8 B-scans at 512^2 on the card
    against the CPU: the quantised levels and the eight co-occurrence
    matrices of each image equal, the 64 features within 1e-5 of each
    feature's largest CPU value."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        glcm,
    )

    xb, _ = train_batch(dev, ZOO_BATCH, SEED + 98)
    img = xb[..., 0].float()
    q, q_cpu = glcm.quantize_reference(img), glcm.quantize_reference(
        img.cpu())
    same = bool((q.cpu() == q_cpu).all())
    for r, c in glcm.reference_offsets():
        same &= bool((glcm.glcm_single(q, r, c).cpu()
                      == glcm.glcm_single(q_cpu, r, c)).all())
    got = glcm.glcm_feature_vector(img).cpu()
    want = glcm.glcm_feature_vector(img.cpu())
    rel = max(float((got[:, k::8] - want[:, k::8]).abs().max()
                    / want[:, k::8].abs().max()) for k in range(8))
    print(f"GLCM features, {tuple(img.shape)}: levels and co-occurrence "
          f"matrices equal on the card and the CPU: {same}; features max "
          f"|difference| / max |CPU| {rel:.3e} (limit 1e-5, per feature)",
          flush=True)
    if not (same and rel <= 1e-5):
        bad.append(f"GLCM card vs CPU: equal {same}, {rel:.3e}")


def bionet_step(dev, bad, time_ms, batch, nc):
    """BioNet at ``batch``: the bf16 eval forward's ms, then one
    train-mode forward and backward of the mean of its three outputs
    (bf16 autocast; no loss or trainer exists for it) with K6 counted
    from 0, its ms, peak memory and profile."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
        get_model,
    )

    on_card = dev.type == "cuda"
    model = get_model("bionet", in_channels=1, num_classes=nc, seed=SEED,
                      device=dev)
    print(f"BioNet ({nc} classes): "
          f"{sum(p.numel() for p in model.parameters()):,} parameters",
          flush=True)
    xb, _ = train_batch(dev, batch, SEED + 90, nc)
    xb = xb.permute(0, 3, 1, 2)

    def forward():
        with torch.autocast(dev.type, torch.bfloat16):
            return model(xb)

    with torch.no_grad():
        ms = time_ms(forward, 5)
    print(f"BioNet forward, batch {batch}, bf16 autocast: {ms:.3f} ms "
          f"(median of 5), {batch / ms * 1e3:.1f} B-scans/s", flush=True)

    def step():
        model.train()
        model.zero_grad(set_to_none=True)
        out = forward()
        sum(o.float().mean() for o in out).backward()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    k6.pair_sums.launches = 0
    step()
    _sync(dev)
    launches = k6.pair_sums.launches
    print(f"BioNet step (forward and backward of the mean of its three "
          f"outputs), batch {batch}: K6 launches {launches} (expected "
          f"{BIONET_K6_PER_STEP})", flush=True)
    if on_card and launches != BIONET_K6_PER_STEP:
        bad.append(f"BioNet: K6 {launches} a step, expected "
                   f"{BIONET_K6_PER_STEP}")
    grads = [p.grad for p in model.parameters()]
    if any(g is None or not bool(torch.isfinite(g).all()) for g in grads):
        bad.append("BioNet: a gradient is missing or not finite")
    for _ in range(2):
        step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    _sync(dev)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if on_card else "not measured")
    print(f"BioNet train step, batch {batch}: {ms:.3f} ms, "
          f"{batch / ms * 1e3:.1f} B-scans/s, peak memory {peak}",
          flush=True)
    if on_card:
        profile_breakdown(step, 3, f"BioNet steps at batch {batch}",
                          {"K6 bn_pair_sums": "pair_sums"})


def zoo3_phase(dev, card, time_ms):
    """Phase 34: MSNet and M2SNet on Res2Net-50, BioNet on ResNet-18,
    WAT-Net, Masood (Gabor, Haar and GLCM features) and RetiFluidNet at
    the JAX defaults' full width from seed ``SEED``: the eval forward on
    the card against the CPU, bf16 forwards, one ``cli train`` epoch each
    at 512^2 (BioNet: one step in the phase) with K6 in every train-mode
    BatchNorm (its launches a step against the counts above), the
    readings, K6 against float64 at M2SNet's 26- and 52-channel
    BatchNorms, and the K6 gate on M2SNet's and WAT-Net's steps (float32,
    TF32 off)."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
        get_model,
    )

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    phase(f"34 MSNet, M2SNet, BioNet, WAT-Net, Masood, RetiFluidNet "
          f"({HW}x{HW}, full width, seed {SEED}) on {card}")
    bad = []
    xs, _ = train_batch(dev, 2, SEED + 96)
    xs = xs.permute(0, 3, 1, 2)[:, :, :ZOO3_SIDE, :ZOO3_SIDE].contiguous()
    xs = xs.cpu()
    for label, name in ZOO3_CARD_VS_CPU:
        cpu_model = get_model(name, in_channels=1, num_classes=NC, seed=SEED)
        if name == "masood":  # GLCM contrast and variance reach ~1e4:
            with torch.no_grad():  # off saturation, the sigmoid shows all
                cpu_model.head.weight[:, -64:] *= 1e-4
            label += ", GLCM head weights x1e-4"
        card_vs_cpu(dev, bad, label, cpu_model, xs)
    glcm_card_vs_cpu(dev, bad)
    retifluid_card_vs_cpu(dev, bad, retifluid_off_saturation(get_model(
        "retifluidnet", num_classes=NC, seed=SEED)), xs, NC)
    bionet_step(dev, bad, time_ms, ZOO_BATCH, NC)
    if on_card:
        torch.cuda.empty_cache()
    for name, label, batch, want in ZOO3:
        model = get_model(name, in_channels=1, num_classes=NC, seed=SEED,
                          device=dev)
        print(f"{label} ({NC} classes): "
              f"{sum(p.numel() for p in model.parameters()):,} parameters",
              flush=True)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        forward_time(dev, time_ms, label, model, ZOO_BATCH, NC)
        if on_card:
            print(f"{label} forward, batch {ZOO_BATCH}: peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  flush=True)
        del model
        trainer, state, per_step = trainer_epoch(dev, bad, name, NC, batch,
                                                 ZOO_STEPS)
        if on_card and per_step != want:
            bad.append(f"{label}: K6 {per_step:g} a step, expected {want}")
        images, labels = step_times(dev, label, trainer, state, batch, NC)
        if on_card and name == "m2snet":
            k6_odd_channels(dev, label, trainer, images, labels, k6, bad)
        if name in ("m2snet", "watnet"):
            k6_gate(label, trainer, images, labels, k6, bad, on_card)
        del trainer, state, images, labels
        if on_card:
            torch.cuda.empty_cache()
    print(f"phase 34: {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    if bad:
        raise RuntimeError(f"phase 34: {bad}")


# ---------------------------------------------------------------- phase 35

MIXED_BATCH = 8  # the mixed graph's K1-vs-plain check (phase 35)
MIXED_TIME_BATCH = 32  # its times beside the PSRP graph's
SPATIAL_BATCH = 2  # the spatially sharded forwards in the two ranks
SPATIAL_INFER_BATCH = 4  # B-scans of infer --spatial
DP_SERVE_BATCH = 8  # dp_serve's batch of the PSRP graph
DP_BATCH = 8  # the global batch of the two-rank Y-Net step
DP_GATE = {"loss": 1e-6, "cosine": 0.99999, "stats": 1e-6}
# The float U-Net H-sharded on the card: the exchange is exact (the int8
# oracle is bit-equal), but cuDNN picks a conv's algorithm by the
# problem's size, and at some conv shapes (phase 35 prints them) the
# shard's takes another order of additions: the logits then differ by
# float32 roundings, the labels not. The CPU is bit-equal
# (tests/test_torch_parallel.py). The JAX package holds the same function
# to atol 1e-4, rtol 1e-4 (tests/test_parallel.py:116-117); ROADMAP.md
# Queue C records C4 as a float32 note against that contract.
SPATIAL_FLOAT_TOL = 1e-6
REMAT_BATCH = 8  # the remat step (U-Net f=32)
BLOCKS_SIDE = 128  # the generic blocks, card vs CPU
MIXED_LAUNCHES = 10  # K1 in the mixed graph's deep region, a forward


@contextlib.contextmanager
def float32_deterministic():
    """float32 convs and matmuls (TF32 off), deterministic cuDNN."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def gloo_cuda_probe(dev):
    """What the installed gloo does with CUDA tensors in its collectives,
    each on a group of its own with a 30 s timeout (no staging): -> {op:
    reading}. send/recv is probed apart (``gloo_send_recv_probe``): a CUDA
    tensor there can kill the process."""
    import datetime

    import torch
    import torch.distributed as dist

    ops = {
        "all_reduce": lambda t, g: dist.all_reduce(t, group=g),
        "broadcast": lambda t, g: dist.broadcast(t, 0, group=g),
        "all_gather": lambda t, g: dist.all_gather(
            [torch.empty_like(t) for _ in range(2)], t, group=g),
    }
    groups = {k: dist.new_group(backend="gloo",
                                timeout=datetime.timedelta(seconds=30))
              for k in ops}
    out = {}
    for name, op in ops.items():
        try:
            op(torch.ones(4, device=dev), groups[name])
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except Exception as e:  # the reading is the refusal itself
            out[name] = (f"refuses them ({type(e).__name__}: "
                         f"{str(e).splitlines()[0][:90]})")
    return out


def gloo_send_recv_probe(dev_name):
    """Rank 0 sends a CUDA tensor to rank 1 over gloo, unstaged (a group
    with a 30 s timeout). -> what rank 1 received."""
    import datetime

    import torch
    import torch.distributed as dist

    g = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=30))
    t = torch.full((4,), 7.0, device=dev_name)
    if dist.get_rank() == 0:
        dist.send(t, 1, group=g)
        return None
    t.zero_()
    dist.recv(t, 0, group=g)
    return t.cpu().tolist()


def _flat_grads(model):
    import torch

    return torch.cat([p.grad.reshape(-1) for p in model.parameters()
                      if p.grad is not None]).double()


def two_rank_checks(dev_name, hw, f, nc, seed):
    """Phase 35 on each of two ranks (gloo; both on ``dev_name``):
    the gloo probe, the float U-Net and the int8 oracle spatially sharded
    against the unsharded forward, dp_serve of the PSRP graph against one
    rank, and the data-parallel Y-Net step (float32, TF32 off, cuDNN
    deterministic) against one rank's step on the whole batch (rank 0).
    -> this rank's readings (numbers and flags only)."""
    import torch
    import torch.distributed as dist

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
        DataConfig,
        ModelConfig,
        TrainConfig,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        quantize_unet_psrp,
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
        build_unet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.collectives import (
        all_gather_cat,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.halo import (
        spatial_shard_infer,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.mesh import (
        create_mesh,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.serving import (
        dp_serve,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.sharding import (
        shard_params,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        Trainer,
        nhwc_logits,
    )

    dev = torch.device(dev_name)
    rank = dist.get_rank()
    out = {"backend": dist.get_backend(), "device": str(dev)}
    if dev.type == "cuda":
        out["gloo_cuda"] = gloo_cuda_probe(dev)
    rng = np.random.default_rng(seed + 120)
    images = torch.tensor(rng.standard_normal((SPATIAL_BATCH, hw, hw, 1)),
                          dtype=torch.float32, device=dev)
    with float32_deterministic(), torch.no_grad():
        space = create_mesh(1, 2)
        model = build_unet(1, nc, init_features=f, seed=seed, device=dev)
        x = preprocess(images)
        t0 = time.perf_counter()
        fwd = lambda m, t: nhwc_logits(m, t, torch.float32)  # noqa: E731
        seen = {}  # leaf module -> [unsharded output, shard's output]
        hooks = [mod.register_forward_hook(
            lambda m, i, o, name=name: seen.setdefault(name, []).append(
                o.detach().clone()))
            for name, mod in model.named_modules()
            if name and not list(mod.children())]
        full = fwd(model, x)
        sharded = spatial_shard_infer(fwd, model, x, space)
        for h in hooks:
            h.remove()
        # the first module whose gathered shards leave the unsharded bits
        out["first_differing_module"] = next(
            ((name, float((all_gather_cat(sh.contiguous(),
                                          space.group("space"), dim=2)
                           - whole).abs().max()))
             for name, (whole, sh) in seen.items()
             if not torch.equal(all_gather_cat(
                 sh.contiguous(), space.group("space"), dim=2), whole)),
            None)
        del seen
        out["spatial_float"] = (bool(torch.equal(full, sharded)),
                                float((full - sharded).abs().max()),
                                float(full.abs().max()),
                                int((full.argmax(-1) != sharded.argmax(-1))
                                    .sum()))
        layers = tq.fold_unet_bn(model)
        # rank 0's qparams on both ranks (the calibration's float convs
        # may differ in their last bits between processes)
        qp = shard_params(space, tq.quantize_unet(
            layers, tq.calibrate_unet(layers, [x])))
        full_q = tq.unet_int8_forward(qp, x)
        sharded_q = spatial_shard_infer(tq.unet_int8_forward, qp, x, space)
        out["spatial_int8"] = (bool(torch.equal(full_q, sharded_q)),
                               float((full_q - sharded_q).abs().max()),
                               float(full_q.abs().max()),
                               int((full_q.argmax(-1) != sharded_q.argmax(-1))
                                   .sum()))
        out["spatial_s"] = time.perf_counter() - t0

        data = create_mesh(2, 1)
        pp = quantize_unet_psrp(layers, tq.calibrate_unet(layers, [x]), f,
                                device=dev)
        xs = preprocess(torch.tensor(
            rng.standard_normal((DP_SERVE_BATCH, hw, hw, 1)),
            dtype=torch.float32, device=dev))
        one = unet_psrp_forward(pp, xs, nc)
        k12.conv3x3_int8.launches = 0
        served = dp_serve(lambda q, t: unet_psrp_forward(q, t, nc),
                          data)(pp, xs)
        out["dp_serve"] = (bool(torch.equal(one, served)),
                           int((one != served).sum()),
                           k12.conv3x3_int8.launches)
        del model, full, sharded, full_q, sharded_q, one, served

    cfg = TrainConfig(model=ModelConfig(name="y_net_gen", num_classes=nc),
                      data=DataConfig(image_size=(hw, hw),
                                      batch_size=DP_BATCH),
                      compute_dtype="float32", seed=seed,
                      mesh_shape={"data": 2, "space": 1})
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.data import (
        SyntheticOCTConfig,
        synth_batch,
    )

    xb, yb = synth_batch(torch.Generator(device=dev).manual_seed(seed + 121),
                         DP_BATCH, SyntheticOCTConfig(height=hw, width=hw,
                                                      num_layers=nc - 2))
    xb = preprocess(xb)
    with float32_deterministic():
        dp = Trainer(cfg, dev)
        state = dp.init_state()
        k6.pair_sums.launches = 0
        loss = float(dp.train_step_fn()(state, xb, yb))
        out["dp_k6"] = k6.pair_sums.launches
        grads = _flat_grads(state.model)
        params = torch.cat([p.detach().reshape(-1).double()
                            for p in state.model.parameters()])
        stats = {k: v.clone() for k, v in state.model.state_dict().items()
                 if "running" in k}
        out["dp_loss"] = loss
        out["dp_param_sum"] = float(params.sum())
        if rank == 0:
            import dataclasses

            one_t = Trainer(dataclasses.replace(cfg, mesh_shape=None), dev)
            one_s = one_t.init_state()
            want = float(one_t.train_step_fn()(one_s, xb, yb))
            wg = _flat_grads(one_s.model)
            out["one_loss"] = want
            out["dp_rel_loss"] = abs(loss - want) / abs(want)
            out["dp_cosine"] = float(grads @ wg / (grads.norm() * wg.norm()))
            out["dp_stats"] = max(
                float((stats[k] - v).abs().max())
                for k, v in one_s.model.state_dict().items() if k in stats)
    return out


def halo_conv_shapes(dev):
    """Each 3x3 conv shape of the f=32 U-Net (batch 2, float32, TF32 off,
    cuDNN deterministic) on the two halo'd halves of its input, in one
    process, against the same rows of the whole conv; NCHW and
    channels-last. -> the shapes whose halves leave the whole conv's
    bits."""
    import torch
    import torch.nn.functional as nnf

    g = torch.Generator(device=dev).manual_seed(SEED + 126)
    shapes = ((512, 1, F), (512, F, F), (256, F, 2 * F),
              (256, 2 * F, 2 * F), (128, 2 * F, 4 * F),
              (128, 4 * F, 4 * F), (64, 4 * F, 8 * F), (64, 8 * F, 8 * F),
              (32, 8 * F, 16 * F), (32, 16 * F, 16 * F),
              (64, 16 * F, 8 * F), (128, 8 * F, 4 * F), (256, 4 * F, 2 * F),
              (512, 2 * F, F))
    differ = []
    with float32_deterministic():
        for fmt in (torch.contiguous_format, torch.channels_last):
            for h, cin, cout in shapes:
                h = h * HW // 512
                x = torch.randn(2, cin, h, h, generator=g,
                                device=dev).contiguous(memory_format=fmt)
                w = torch.randn(cout, cin, 3, 3, generator=g,
                                device=dev) / (9 * cin) ** 0.5
                whole = nnf.conv2d(x, w, padding=1)
                z = torch.zeros_like(x[:, :, :1])
                halves = (torch.cat([z, x[:, :, :h // 2 + 1]], 2),
                          torch.cat([x[:, :, h // 2 - 1:], z], 2))
                sharded = torch.cat([nnf.conv2d(
                    t.contiguous(memory_format=fmt), w, padding=(0, 1))
                    for t in halves], 2)
                if not torch.equal(sharded, whole):
                    differ.append(f"{h}^2 {cin}->{cout} "
                                  f"{'channels-last' if fmt == torch.channels_last else 'NCHW'}")
    return differ


def blocks_card_vs_cpu(dev, bad):
    """The generic blocks (``models/blocks``) and SD_Layer_Net's AttU_Net4
    at narrow channels: the card against the CPU, float32 with TF32 off,
    eval and train forward, 1e-4 of the largest CPU output."""
    import copy

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
        blocks as b,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.sdnet.unet import (
        AttU_Net4,
    )

    g = torch.Generator().manual_seed(SEED + 125)
    cases = (("PReLU", b.PReLU(), (16,)),
             ("ConvBNAct", b.ConvBNAct(16, 32, generator=g), (16,)),
             ("DoubleConv", b.DoubleConv(16, 32, generator=g), (16,)),
             ("SqueezeExcitation", b.SqueezeExcitation(32, generator=g),
              (32,)),
             ("AttentionGate", b.AttentionGate(32, 16, 8, generator=g),
              (32, 16)),
             ("ASPP", b.ASPP(16, 32, generator=g), (16,)),
             ("SeparableConv", b.SeparableConv(16, 32, generator=g), (16,)),
             ("AttU_Net4", AttU_Net4(3, (8, 16, 32, 64), seed=SEED), (1,)))
    worst = 0.0
    with float32_deterministic():
        for name, cpu_m, cins in cases:
            xs = [torch.randn((2, c, BLOCKS_SIDE, BLOCKS_SIDE), generator=g)
                  for c in cins]
            card_m = copy.deepcopy(cpu_m).to(dev)
            for train in (False, True):
                cpu_m.train(train)
                card_m.train(train)
                with torch.no_grad():
                    want = cpu_m(*xs)
                    got = card_m(*[x.to(dev) for x in xs]).cpu()
                rel = float((got - want).abs().max() / want.abs().max())
                worst = max(worst, rel)
                if not rel <= 1e-4:
                    bad.append(f"{name} {'train' if train else 'eval'} "
                               f"card vs CPU {rel:.3e}")
                print(f"{name} ({'train' if train else 'eval'}): card vs "
                      f"CPU {rel:.3e}", flush=True)
    return worst


def parallel_phase(dev, card, time_ms, model, calib):
    """Phase 35: the mixed int8 graph on K1 (both shallow modes), the
    parallel runtime on two ranks (gloo, both on the one card: infer
    --spatial 2, spatial inference, dp_serve, the data-parallel Y-Net
    step), the remat step and the generic blocks."""
    import os
    import tempfile

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
        cli,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
        build_unet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.launch import (
        run_ranks,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        losses,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
        create_train_state,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        make_train_step,
    )

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    phase(f"35 mixed int8 graph, parallel runtime (two ranks), remat, "
          f"generic blocks ({HW}x{HW}, f={F}) on {card}")
    bad = []

    # the mixed graph, from phase 3's folded layers and taps
    mq = tq.quantize_unet_mixed(calib["layers"], calib["taps"])
    x8 = preprocess(torch.tensor(
        np.random.default_rng(SEED + 2).standard_normal(
            (MIXED_BATCH, HW, HW, 1)), dtype=torch.float32, device=dev))

    def k1_plain(inputs, w, scale, bias, **kw):
        return k12.conv3x3_int8_reference(inputs, w, scale, bias, **kw)

    with torch.inference_mode():
        ref32 = tq.folded_forward(calib["layers"], x8).argmax(-1)
        ref8 = tq.unet_int8_forward(tq.quantize_unet(calib["layers"],
                                                     calib["taps"]),
                                    x8).argmax(-1)
        for shallow in ("bf16", "int8"):
            with float32_deterministic():
                k12.conv3x3_int8.launches = 0
                lab = tq.unet_mixed_forward(mq, x8, shallow=shallow).argmax(-1)
                _sync(dev)
                launches = k12.conv3x3_int8.launches
                with swapped(tq, conv3x3_int8=k1_plain):
                    plain = tq.unet_mixed_forward(mq, x8,
                                                  shallow=shallow).argmax(-1)
                xla = tq.unet_mixed_forward(mq, x8, shallow=shallow,
                                            deep="xla").argmax(-1)
            mism = int((lab != plain).sum())
            a32 = float((lab == ref32).float().mean())
            a8 = float((lab == ref8).float().mean())
            ax = float((lab == xla).float().mean())
            print(f"mixed graph shallow={shallow}, batch {MIXED_BATCH}: K1 "
                  f"vs its plain version {mism} label mismatches; K1 "
                  f"launches a forward {launches} (want {MIXED_LAUNCHES}); "
                  f"agreement with folded_forward {a32:.6f} (JAX's contract "
                  f">= 0.98 is on a trained checkpoint), with "
                  f"unet_int8_forward {a8:.6f}, with deep='xla' {ax:.6f}",
                  flush=True)
            if mism:
                bad.append(f"mixed {shallow}: {mism} mismatches")
            if on_card and launches != MIXED_LAUNCHES:
                bad.append(f"mixed {shallow}: K1 {launches} launches")
        if on_card:
            xt = preprocess(torch.tensor(
                np.random.default_rng(SEED + 4).standard_normal(
                    (MIXED_TIME_BATCH, HW, HW, 1)), dtype=torch.float32,
                device=dev))
            times = {}
            for _ in range(2):  # in turns
                for label, fn in (
                        ("mixed bf16", lambda: tq.unet_mixed_forward(
                            mq, xt, shallow="bf16")),
                        ("mixed int8", lambda: tq.unet_mixed_forward(
                            mq, xt, shallow="int8")),
                        ("psrp", lambda: unet_psrp_forward(
                            calib["qparams"], xt, NC))):
                    times.setdefault(label, []).append(time_ms(fn))
            print(f"forward at batch {MIXED_TIME_BATCH} (CUDA events, median "
                  "of 10, two turns): " + ", ".join(
                      f"{k} {' / '.join(f'{v:.3f}' for v in vs)} ms"
                      for k, vs in times.items()), flush=True)
    del mq

    # the parallel runtime on two ranks of the one card
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(two_rank_checks, 2, str(dev), HW, F, NC, SEED,
                      backend="gloo")
    r0, r1 = ranks
    print(f"two ranks ({r0['backend']}, both on {r0['device']}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if "gloo_cuda" in r0:
        for op, what in r0["gloo_cuda"].items():
            print(f"gloo with a CUDA tensor, {op}: {what}")
        try:
            got = run_ranks(gloo_send_recv_probe, 2, str(dev),
                            backend="gloo", timeout=120)[1]
            what = f"rank 1 received {got}"
        except RuntimeError as e:  # the reading is the failure itself
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            what = f"fails: {lines[0]} ... {lines[-1][:160]}"
        print(f"gloo with a CUDA tensor, send/recv (unstaged): {what} "
              "(the sender's stderr above shows why); the runtime sends "
              "gloo's halo rows through host buffers", flush=True)
    for r, rd in enumerate(ranks):
        for key in ("spatial_float", "spatial_int8"):
            eq, diff, top, labels = rd[key]
            print(f"rank {r}: {key.replace('_', ' ')} (batch "
                  f"{SPATIAL_BATCH}, H over 2 ranks) vs unsharded: "
                  f"{'bit-equal' if eq else f'max |diff| {diff:.3e}'} "
                  f"(max |logit| {top:.3e}), {labels} labels differ")
            # the int8 oracle's sums are exact: bit for bit; the float
            # U-Net within SPATIAL_FLOAT_TOL (module note there)
            ok = eq if key == "spatial_int8" else \
                labels == 0 and diff <= SPATIAL_FLOAT_TOL * top
            if not ok:
                bad.append(f"rank {r} {key} {diff:.3e}, {labels} labels")
        if r == 0:
            print(f"first module whose gathered shards differ (float "
                  f"U-Net): {rd['first_differing_module']}")
        eq, n, launches = rd["dp_serve"]
        print(f"rank {r}: dp_serve PSRP (batch {DP_SERVE_BATCH}) vs one "
              f"rank: {n} label mismatches; K1 launches on this rank's "
              f"shard {launches}")
        if not eq:
            bad.append(f"rank {r} dp_serve {n}")
    if on_card:
        print("3x3 conv shapes whose halo'd halves leave the whole conv's "
              f"bits (one process): {halo_conv_shapes(dev) or 'none'}",
              flush=True)
    dp_ok = (r0["dp_loss"] == r1["dp_loss"]
             and r0["dp_param_sum"] == r1["dp_param_sum"]
             and r0["dp_rel_loss"] < DP_GATE["loss"]
             and r0["dp_cosine"] > DP_GATE["cosine"]
             and r0["dp_stats"] <= DP_GATE["stats"])
    print(f"Y-Net data-parallel step (2 ranks x {DP_BATCH // 2}) vs one "
          f"rank on the batch of {DP_BATCH}, float32, TF32 off: relative "
          f"loss {r0['dp_rel_loss']:.3e} (< {DP_GATE['loss']}), gradient "
          f"cosine {r0['dp_cosine']:.9f} (> {DP_GATE['cosine']}), running "
          f"statistics {r0['dp_stats']:.3e} (<= {DP_GATE['stats']}); ranks "
          f"agree: {r0['dp_loss'] == r1['dp_loss']} loss, "
          f"{r0['dp_param_sum'] == r1['dp_param_sum']} parameters; K6 "
          f"launches a step {r0['dp_k6']} / {r1['dp_k6']} per rank",
          flush=True)
    if not dp_ok:
        bad.append("data-parallel step")
    if on_card and not (r0["dp_k6"] and r1["dp_k6"]):
        bad.append("K6 not launched in the data-parallel step")

    with tempfile.TemporaryDirectory() as tmp:
        for quantize in ("off", "int8"):
            masks = {}
            for spatial in (1, 2):
                out = os.path.join(tmp, f"{quantize}_{spatial}")
                t0 = time.perf_counter()
                cli.main(["infer", "--model", "unet", "--num-classes",
                          str(NC), "--image-size", str(HW), "--batch-size",
                          str(SPATIAL_INFER_BATCH), "--dtype", "float32",
                          "--device", str(dev.type), "--quantize", quantize,
                          "--spatial", str(spatial), "--out-dir", out])
                masks[spatial] = np.load(os.path.join(out, "masks.npy"))
                print(f"cli infer --quantize {quantize} --spatial {spatial}:"
                      f" {time.perf_counter() - t0:.1f} s", flush=True)
            diff = int((masks[1] != masks[2]).sum())
            print(f"infer --quantize {quantize}: --spatial 2 vs --spatial 1 "
                  f"masks {masks[1].shape}: {diff} differ", flush=True)
            if diff:
                bad.append(f"infer --spatial 2 {quantize}: {diff}")

    # the dry run's entry point, on its default device, the card
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, dev.type)
    print(f"dryrun_multichip(2) on {dry['device']} over {dry['backend']} "
          f"in {time.perf_counter() - t0:.1f} s: loss {dry['dp_loss']:.6f}, "
          f"w4a4 dp_serve equal to the local shard "
          f"{dry['dp_int4_local_equal']}", flush=True)
    if not (dry["device"].startswith(dev.type) and np.isfinite(dry["dp_loss"])
            and dry["dp_int4_local_equal"]):
        bad.append(f"dryrun_multichip(2): {dry}")

    # remat: the generic step with the whole forward recomputed
    xb, yb = train_batch(dev, REMAT_BATCH, SEED + 122)
    res = {}
    with float32_deterministic():
        for remat in (None, "full"):
            m = build_unet(1, NC, init_features=F, seed=SEED, device=dev)
            state = create_train_state(m.train(), cli.OptimConfig())
            step = make_train_step(losses.dice_ce_loss, dtype=torch.float32,
                                   remat=remat)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            k6.pair_sums.launches = 0
            loss = step(state, xb, yb)
            _sync(dev)
            peak = (torch.cuda.max_memory_allocated() / 1e9 if on_card
                    else float("nan"))
            res[remat] = (loss, _flat_grads(m), {
                k: v.clone() for k, v in m.state_dict().items()
                if "running" in k}, peak, k6.pair_sums.launches)
    (l0, g0, s0, p0, n0), (l1, g1, s1, p1, n1) = res[None], res["full"]
    remat_ok = (bool(torch.equal(l0, l1)) and bool(torch.equal(g0, g1))
                and all(torch.equal(s0[k], s1[k]) for k in s0))
    print(f"remat='full' vs plain step (U-Net f={F}, batch {REMAT_BATCH}, "
          f"float32): loss {'equal' if torch.equal(l0, l1) else 'differs'},"
          f" gradients {'bit-equal' if torch.equal(g0, g1) else 'differ'} "
          f"(max |diff| {float((g0 - g1).abs().max()):.3e}), running "
          f"statistics {'equal (moved once)' if remat_ok else 'differ'}; "
          f"K6 launches {n0} / {n1} (the recompute runs the forward's "
          f"again); peak {p0:.2f} GB plain, {p1:.2f} GB remat", flush=True)
    if not remat_ok:
        bad.append("remat step")

    if on_card:
        blocks_card_vs_cpu(dev, bad)
    print(f"phase 35 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        raise RuntimeError(f"phase 35: {bad}")


PACKED_DP_BATCH = 8  # phase 36's global batch: 2 ranks x 4
PACKED_DP_CASES = {"unfused": {}, "fused": {"fused_loss": True},
                   "remat": {"remat": True},
                   "kernel": {"deep": "kernel", "mid": "kernel"}}
# the packed step on 2 ranks x 4 vs 1 rank x 8 from the trained state:
# relative loss, lowest gradient cosine, largest change of a gradient's
# norm, and the largest running-statistic difference relative to that
# buffer's largest value, between the one-ulp floor and the nearest of two
# planted faults (K6's sums and K8's statistics left unreduced; PERF.md
# section 6). Every reading of the correct step sits at the floor's order
# (its running statistics 9.8e-05 against the floor's 7.5e-05: the bf16
# activations round the other way where a statistic moves by an ulp);
# statistics at 5e-4, between those and the K6 fault's 4.9e-03
PACKED_DP_GATE = {"loss": 1e-5, "cosine": 0.9999, "norm": 3e-3,
                  "stats": 5e-4}
PACKED_DP_STEPS = 5  # timed steps a rank, after two warm-up steps


def state_digest(model):
    """sha256 of every parameter and buffer of ``model``, in order."""
    import hashlib

    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_agreement(a, b):
    """``agreement`` of two (loss, {name: gradient}, {name: running
    statistic}) steps, and the largest |a - b| / max |b| over the running
    statistics."""
    stats = max(float((a[2][k] - b[2][k]).abs().max()
                      / b[2][k].abs().max().clamp_min(1e-30)) for k in b[2])
    return agreement(a[:2], b[:2]) + (stats,)


def dp_passes(agree):
    return gate_passes(agree[:3], PACKED_DP_GATE) and \
        agree[3] < PACKED_DP_GATE["stats"]


def dp_reading(agree):
    return f"{reading(agree[:3])}, running statistics {agree[3]:.3e}"


def packed_dp_checks(dev_name, trained_path, ckpt_dir, hw, f, nc, batch):
    """Phase 36 on each of two ranks (gloo; both on ``dev_name``): the
    packed step (U-Net ``f``, ``nc`` classes, ``hw`` square, global batch
    ``batch``) on the data mesh from the trained state in each case of
    ``PACKED_DP_CASES`` and with each planted fault, rank 0 also on one
    rank over the whole batch (and on a one-ulp input change); its time a
    step and peak memory; then ``cli train --packed`` for one epoch inside
    the group. -> this rank's readings (numbers, digests and flags)."""
    import torch
    import torch.distributed as dist

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
        cli,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
        OptimConfig,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_bf16 as k45,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        dice_ce as k89,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.mesh import (
        create_mesh,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        checkpoint as tckpt,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        packed_unet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
        dice_ce_loss,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
        create_train_state,
    )

    dev = torch.device(dev_name)
    rank = dist.get_rank()
    on_card = dev.type == "cuda"
    every = {"conv3x3_bf16": k45.conv3x3_bf16_fwd,
             "conv3x3_bf16_wgrad": k45.conv3x3_bf16_wgrad,
             "bn_pair_sums": k6.pair_sums,
             "dice_ce_stats": k89.dice_ce_stats,
             "dice_ce_bwd": k89.dice_ce_bwd}

    def reset():
        for w in every.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in every.items() if w.launches}

    data = create_mesh(2, 1)
    trained = torch.load(trained_path, map_location=dev, weights_only=True)
    x8, y8 = train_batch(dev, batch, SEED + 20, nc, hw)

    def fresh(kw, mesh):
        model = seeded_unet(dev, f, nc)
        model.load_state_dict(trained)
        state = create_train_state(model, OptimConfig())
        return state, packed_unet.make_packed_train_step(
            dice_ce_loss, mesh=mesh, **kw)

    def step(kw, mesh=data, x=x8):
        """One step from the trained state -> ((loss, gradients, running
        statistics), launches, digest of the state after it)."""
        state, fn = fresh(kw, mesh)
        reset()
        loss = float(fn(state, x, y8))
        _sync(dev)
        launches = counts()
        m = state.model
        return ((loss, {n: p.grad.detach().double()
                        for n, p in m.named_parameters()},
                 {k: v.detach().clone() for k, v in m.state_dict().items()
                  if "running" in k}), launches, state_digest(m))

    out = {"launches": {}, "digest": {}}
    dp = {}
    for case, kw in PACKED_DP_CASES.items():
        dp[case], out["launches"][case], out["digest"][case] = step(kw)
    faults = {}
    for label, kw, fault in (
            ("K6 sums unreduced (per-rank BN statistics)", {},
             swapped(k6, _global=lambda sums, m, group: (sums, m))),
            ("K8 statistics unreduced (per-rank loss)", {"fused_loss": True},
             swapped(k89, _global=lambda stats, group: stats))):
        with fault:
            faults[label] = (step(kw)[0], "fused" if kw else "unfused")
    if rank == 0:
        one = {case: step(kw, None)[0]
               for case, kw in PACKED_DP_CASES.items()}
        out["agree"] = {case: dp_agreement(dp[case], one[case])
                        for case in dp}
        out["floor"] = dp_agreement(
            step({}, None, one_ulp_change(x8, dev))[0], one["unfused"])
        out["faults"] = {label: dp_agreement(got, one[case])
                         for label, (got, case) in faults.items()}
        out["remat_vs_plain"] = dp_agreement(dp["remat"], dp["unfused"])
        del one
    del dp, faults

    # time a step and the peak memory of this rank
    state, fn = fresh({}, data)
    for _ in range(2):
        fn(state, x8, y8)
    _sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(PACKED_DP_STEPS):
        fn(state, x8, y8)
    _sync(dev)
    out["step_ms"] = (time.perf_counter() - t0) / PACKED_DP_STEPS * 1e3
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9 if on_card
                      else float("nan"))
    del state, fn

    # the main path: cli train --packed inside the group (its local_mesh)
    saved = []
    save = tckpt.CheckpointManager.save

    def spy(self, *args, **kwargs):
        saved.append(rank)
        return save(self, *args, **kwargs)

    argv = ["train", "--packed", "--image-size", str(hw), "--num-classes",
            str(nc), "--batch-size", str(batch), "--num-train",
            str(2 * batch), "--num-val", str(batch), "--epochs", "1",
            "--device", dev_name, "--model-kwargs",
            json.dumps({"init_features": f}), "--checkpoint-dir", ckpt_dir]
    with swapped(tckpt.CheckpointManager, save=spy):
        reset()
        t0 = time.perf_counter()
        state = cli.main(argv)
        _sync(dev)
        out["train_s"] = time.perf_counter() - t0
        out["train_launches"] = counts()
    out["train_step"] = state.step
    out["train_digest"] = state_digest(state.model)
    out["saved"] = saved
    return out


def packed_dp_phase(dev, card, trained):
    """Phase 36: the packed U-Net step data-parallel on two ranks of the
    one card (gloo) against one rank on the whole batch, planted faults,
    launches a rank, ``cli train --packed`` in the two ranks and ``eval
    --checkpoint`` on what it wrote."""
    import glob
    import os
    import tempfile

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
        cli,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.launch import (
        run_ranks,
    )

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    phase(f"36 packed U-Net step on two ranks (gloo, both on {card}): f={F}, "
          f"{NC} classes, {HW}x{HW}, 2 x {PACKED_DP_BATCH // 2} against 1 x "
          f"{PACKED_DP_BATCH}, from phase 7's trained state")
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trained.pt")
        torch.save(trained, path)
        ckpt = os.path.join(tmp, "ckpt")
        r0, r1 = run_ranks(packed_dp_checks, 2, str(dev), path, ckpt, HW,
                           F, NC, PACKED_DP_BATCH, backend="gloo")
        print(f"one-ulp floor (one rank, 1e-4 of the pixels one bf16 ulp "
              f"up): {dp_reading(r0['floor'])}")
        for case, agree in r0["agree"].items():
            equal = r0["digest"][case] == r1["digest"][case]
            print(f"{case}: 2 ranks vs 1 rank: {dp_reading(agree)}; ranks' "
                  f"parameters and buffers {'equal' if equal else 'DIFFER'}"
                  f"; launches a step, rank 0 {r0['launches'][case]}, rank 1 "
                  f"{r1['launches'][case]}", flush=True)
            if not dp_passes(agree):
                bad.append(f"{case} step")
            if not equal:
                bad.append(f"{case}: ranks differ")
        print(f"remat vs plain on the two ranks: "
              f"{dp_reading(r0['remat_vs_plain'])}")
        for label, agree in r0["faults"].items():
            print(f"planted fault, {label}: {dp_reading(agree)}", flush=True)
            if dp_passes(agree):
                bad.append(f"the gate passes {label}")
        print(f"gate: relative loss < {PACKED_DP_GATE['loss']}, cosine > "
              f"{PACKED_DP_GATE['cosine']}, norm change < "
              f"{PACKED_DP_GATE['norm']}, running statistics < "
              f"{PACKED_DP_GATE['stats']}")
        if on_card:
            for case, kw in PACKED_DP_CASES.items():
                base = dict(LAUNCHES_PER_STEP[kw.get("deep", "torch")])
                if case == "fused":
                    base.update(dice_ce_stats=1, dice_ce_bwd=1)
                for r, rd in enumerate((r0, r1)):
                    got = rd["launches"][case]
                    ok = got["bn_pair_sums"] > base["bn_pair_sums"] and \
                        got["conv3x3_bf16"] >= base["conv3x3_bf16"] \
                        if case == "remat" else got == base
                    if not ok:
                        bad.append(f"rank {r} {case} launches {got}, "
                                   f"expected {base}")
        print(f"{card}: step (2 x {PACKED_DP_BATCH // 2}, unfused, host "
              f"clock over {PACKED_DP_STEPS} steps after 2) rank 0 "
              f"{r0['step_ms']:.3f} ms, rank 1 {r1['step_ms']:.3f} ms; peak "
              f"{r0['peak_gb']:.2f} / {r1['peak_gb']:.2f} GB a rank (two "
              "ranks share one card: a correctness path, no multi-card "
              "speed)", flush=True)

        # the main path: cli train --packed in the two ranks, then eval
        print(f"cli train --packed in the two ranks, one epoch of "
              f"{2 * PACKED_DP_BATCH} B-scans: {r0['train_s']:.1f} / "
              f"{r1['train_s']:.1f} s, steps {r0['train_step']}; launches "
              f"rank 0 {r0['train_launches']}, rank 1 "
              f"{r1['train_launches']}; saved by ranks {r0['saved']} + "
              f"{r1['saved']}", flush=True)
        want = {k: 2 * v for k, v in LAUNCHES_PER_STEP["torch"].items()}
        for r, rd in enumerate((r0, r1)):
            if on_card and rd["train_launches"] != want:
                bad.append(f"rank {r} train launches, expected {want}")
        if r0["train_digest"] != r1["train_digest"]:
            bad.append("cli train: ranks differ")
        if (r0["saved"], r1["saved"], r0["train_step"]) != ([0], [], 2):
            bad.append("cli train: saves or steps")
        files = sorted(glob.glob(os.path.join(ckpt, "ckpt_*.pt")))
        argv = ["eval", "--model", "unet", "--num-classes", str(NC),
                "--image-size", str(HW), "--batch-size", str(TRAIN_BATCH),
                "--num-val", str(TRAIN_BATCH), "--device", dev.type,
                "--model-kwargs", json.dumps({"init_features": F}),
                "--checkpoint", files[0] if files else "missing"]
        trainer, _ = cli.build_eval_trainer(cli.parser().parse_args(argv))
        read = state_digest(trainer.model) == r0["train_digest"]
        del trainer
        with contextlib.redirect_stdout(io.StringIO()):
            m = cli.main(argv)
        pixels = int(m["confusion"].sum())
        print(f"checkpoints written {[os.path.basename(f) for f in files]}; "
              f"eval --checkpoint reads rank 0's state: {read}; confusion "
              f"sum {pixels} (want {TRAIN_BATCH * HW * HW}), pixel accuracy "
              f"{m['pixel_accuracy']:.4f}", flush=True)
        if len(files) != 1 or not read or pixels != TRAIN_BATCH * HW * HW:
            bad.append("eval --checkpoint")
    print(f"phase 36 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        raise RuntimeError(f"phase 36: {bad}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.http_server import (
        start_in_background,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.server import (
        ServingLoop,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        head_argmax as k3,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )

    dev = torch.device("cuda", 0)
    wrappers = {"conv3x3_int8": k12.conv3x3_int8, "ct2x2_int8": k12.ct2x2_int8,
                "head_argmax": k3.head_argmax}
    plains = {"conv3x3_int8": k12.conv3x3_int8_reference,
              "ct2x2_int8": k12.ct2x2_int8_reference,
              "head_argmax": k3.head_argmax_reference}

    # ------------------------------------------------------------------ 1
    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    cc = torch.cuda.get_device_capability(0)
    if cc != (9, 0):
        raise RuntimeError(f"compute capability {cc}, the kernels are sm_90a")
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    print(f"kernels built and loaded in {time.time() - t0:.1f} s: "
          f"{lib_path.name}", flush=True)

    gen = np.random.default_rng(SEED)

    def i8(shape, lo=-127, hi=128):
        return torch.tensor(gen.integers(lo, hi, shape), dtype=torch.int8,
                            device=dev)

    def stage_args(kernel, shape, n):
        """Seeded inputs of one stage at batch n (scale/bias keep the
        outputs spread over the int8 range)."""
        if kernel == "conv3x3_int8":
            h, cins, cout, pool = shape
            xs = tuple(i8((n, h, h, c), 0, 128) for c in cins)
            wq = i8((cout, sum(cins), 3, 3))
            std = (9 * sum(cins)) ** 0.5 * 64 * 73
            kw = {"relu": True, "pool": pool}
            # packed once, as the graph's w_m
            kw["w_mma"] = (k12.pack_stem_mma_weights(wq) if cins == (1,)
                           else k12.pack_conv3x3_mma_weights(wq))
            args = (xs, k12.pack_conv3x3_weights(wq))
        elif kernel == "ct2x2_int8":
            h, cin, cout = shape
            args = (i8((n, h, h, cin)),
                    k12.pack_ct2x2_weights(i8((cin, cout, 2, 2))))
            std, kw = cin ** 0.5 * 73 * 73, {}
        else:
            h, cin = shape
            x = i8((n, h, h, cin))
            x[0, 0] = 0  # a row of all-zero pixels: logits = bias
            cout = NC
            args = (x, k3.pack_head_weights(i8((NC, cin, 1, 1))))
            std, kw = cin ** 0.5 * 73 * 73, {}
        scale = torch.tensor(gen.uniform(30, 60, cout) / std,
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-5, 5, cout), dtype=torch.float32,
                            device=dev)
        if kernel == "head_argmax":
            bias[3] = bias[7] = 10.0  # the all-zero row ties 3 and 7
        return args + (scale, bias), kw

    def as_tuple(t):
        return t if isinstance(t, tuple) else (t,)

    def k1_plan(args):
        """The plan K1's wrapper takes for these arguments (no head)."""
        xs, _, scale, _ = args
        N, H, W, _ = xs[0].shape
        return k12.conv3x3_plan(N, H, W, tuple(x.shape[-1] for x in xs),
                                scale.shape[0], False,
                                all(x.data_ptr() % 16 == 0 for x in xs))

    def k1_plan_text(plan):
        """K1's launch: the stem body's grid, the mma.sync body's tile."""
        if plan.body == "stem":
            return (f"N {plan.co_t}, {plan.warps}-row tiles, grid "
                    f"{plan.grid}, {plan.blocks_per_sm} blocks an SM")
        return (f"N {plan.co_t}, {plan.warps} warps, stages "
                f"{plan.stages}")

    def k2_plan_text(args):
        """K2's launch for these arguments: tile pixels x channels, the
        grid and the loader."""
        x, _, scale, _ = args
        plan = k12.ct2x2_plan(*x.shape, scale.shape[0],
                              x.data_ptr() % 16 == 0,
                              torch.cuda.get_device_properties(
                                  x.device).multi_processor_count)
        return (f"{plan.tm}x{plan.co_t} grid {plan.grid}x{plan.n_co} "
                f"{plan.loader}")

    def k1_dp4a(args, kw):
        """One launch of K1's dp4a body through its own C entry point, with
        the int8 graph's knobs (relu, zero borders, no head)."""
        xs, w, scale, bias = args
        x1 = xs[1] if len(xs) > 1 else None
        N, H, W, cin0 = xs[0].shape
        cout, pool = scale.shape[0], kw["pool"]
        y = torch.empty((N, H, W, cout), dtype=torch.int8, device=dev)
        yp = torch.empty((N, H // 2, W // 2, cout), dtype=torch.int8,
                         device=dev) if pool else None
        _build.check(_build.lib().octseg_conv3x3_int8(
            xs[0].data_ptr(), cin0, x1.data_ptr() if x1 is not None else None,
            x1.shape[-1] if x1 is not None else 0, w.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            yp.data_ptr() if pool else None, N, H, W, 4 * w.shape[1], cout,
            w.shape[2], int(kw["relu"]), 0, 0, 127.0, 1.0, 0.0, 127.0, None,
            None, None, 0, None, torch.cuda.current_stream().cuda_stream),
            "conv3x3_int8 (dp4a)")
        return (y, yp) if pool else y

    # ------------------------------------------------------------------ 2
    phase("2 kernels vs plain versions (batch 2, every stage)")
    max_err = {k: 0 for k in wrappers}
    bad = 0
    off_mma = []  # K1 stages the plan leaves off their tensor-core body
    for name, kernel, shape in stages():
        args, kw = stage_args(kernel, shape, 2)
        got = wrappers[kernel](*args, **kw)
        want = plains[kernel](*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        mism = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = max(int((g.int() - w.int()).abs().max()) for g, w in
                  zip(got, want))
        max_err[kernel] = max(max_err[kernel], err)
        extra = ""
        if kernel == "head_argmax":
            tie = got[0][0, 0]
            extra = f", tie row labels {sorted(set(tie.tolist()))}"
            if not bool((tie == 3).all()):
                raise RuntimeError("head tie did not go to the lowest class")
        if kernel == "conv3x3_int8":
            plan = k1_plan(args)
            extra = f", body {plan.body} ({k1_plan_text(plan)})"
            if plan.body != ("stem" if name.startswith("stem") else "mma"):
                off_mma.append(name)
        if kernel == "ct2x2_int8":
            extra = f", plan {k2_plan_text(args)}"
            if name in ("ct0", "ct3"):  # a second call: the same bits
                again = wrappers[kernel](*args, **kw)
                torch.cuda.synchronize()
                if not torch.equal(again, got[0]):
                    raise RuntimeError(f"K2's second call differs at {name}")
                extra += ", second call identical"
        print(f"{name:16s} {kernel:13s} {str(shape):28s} outputs "
              f"{[tuple(g.shape) for g in got]} mismatches {mism}{extra}",
              flush=True)
        bad += mism
    # K2 at +-127 inputs and weights (ct0: |acc| up to 512 * 127^2 =
    # 8,258,048), and where the pixels are not a multiple of the tile
    h0, c0, o0 = next(s for n_, k, s in stages() if n_ == "ct0")
    k2_odd = {"ct0 +-127": (2, h0, h0, c0, o0, True),
              "ct3 edge": (1, 5, 250, 64, 32, False)}
    for label, (n, hh, ww, cin, cout, ext) in k2_odd.items():
        vals = np.array([-127, 127])
        x = (torch.tensor(gen.choice(vals, (n, hh, ww, cin)),
                          dtype=torch.int8, device=dev) if ext
             else i8((n, hh, ww, cin)))
        wq = (torch.tensor(gen.choice(vals, (cin, cout, 2, 2)),
                           dtype=torch.int8, device=dev) if ext
              else i8((cin, cout, 2, 2)))
        if ext:
            x[0, 0, 0] = 127
            wq[:, 0] = 127  # that pixel's columns 0: 512 * 127^2
        std = cin ** 0.5 * (127 ** 2 if ext else 73 ** 2)
        args = (x, k12.pack_ct2x2_weights(wq),
                torch.tensor(gen.uniform(30, 60, cout) / std,
                             dtype=torch.float32, device=dev),
                torch.tensor(gen.uniform(-5, 5, cout), dtype=torch.float32,
                             device=dev))
        got = k12.ct2x2_int8(*args)
        want = k12.ct2x2_int8_reference(*args)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        tm = k12.ct2x2_plan(n, hh, ww, cin, cout).tm
        print(f"K2 {label:10s} {(n, hh, ww, cin, cout)} plan "
              f"{k2_plan_text(args)} ({n * hh * ww} pixels, tiles of {tm}), "
              f"max |out| {int(got.abs().max())}, "
              f"mismatches {mism}", flush=True)
        max_err["ct2x2_int8"] = max(max_err["ct2x2_int8"], int(
            (got.int() - want.int()).abs().max()))
        bad += mism
    # K1's stem body at +-127 inputs and weights (|acc| up to 9 * 127^2),
    # at f=16, at an edge shape, with positive inputs and weights whose
    # border pixels (fewer taps) lie below their inner neighbours, and
    # called twice on the same inputs
    for label, (n, hh, ww, cout, case) in {
            "stem +-127": (2, HW, HW, F, "ext"),
            "stem f=16": (2, HW, HW, 16, "rand"),
            "stem edge": (2, 80, 48, F, "rand"),
            "stem borders": (2, HW, HW, F, "borders")}.items():
        if case == "ext":
            vals = np.array([-127, 127])
            x = torch.tensor(gen.choice(vals, (n, hh, ww, 1)),
                             dtype=torch.int8, device=dev)
            wq = torch.tensor(gen.choice(vals, (cout, 1, 3, 3)),
                              dtype=torch.int8, device=dev)
            x[0, :3, :3] = 127
            wq[0] = 127  # pixel (0, 1, 1), channel 0: 9 * 127^2
            std = 3 * 127 ** 2
        elif case == "borders":
            # the biases small against the sums, few outputs clipped: a
            # border pixel (6 or 4 taps) lies below its inner neighbour
            # (9 taps), and a halo that is not zero would show
            x, wq = i8((n, hh, ww, 1), 100, 128), i8((cout, 1, 3, 3), 1, 128)
            std = 9 * 127 ** 2 / 4
        else:
            x, wq = i8((n, hh, ww, 1)), i8((cout, 1, 3, 3))
            std = 3 * 73 * 73
        args = ((x,), k12.pack_conv3x3_weights(wq),
                torch.tensor(gen.uniform(30, 60, cout) / std,
                             dtype=torch.float32, device=dev),
                torch.tensor(gen.uniform(-5, 5, cout), dtype=torch.float32,
                             device=dev))
        plan = k1_plan(args)
        wm = k12.pack_stem_mma_weights(wq)
        got = k12.conv3x3_int8(*args, w_mma=wm)
        again = k12.conv3x3_int8(*args, w_mma=wm)
        want = k12.conv3x3_int8_reference(*args)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        repeat = int((again != got).sum())
        note = ""
        if case == "borders":  # rows 0 and H-1, columns 0 and W-1
            inner = want[:, 1:-1, 1:-1].int()
            lower = [float((edge.int() < nb).float().mean()) for edge, nb in
                     ((want[:, 0, 1:-1], inner[:, 0]),
                      (want[:, -1, 1:-1], inner[:, -1]),
                      (want[:, 1:-1, 0], inner[:, :, 0]),
                      (want[:, 1:-1, -1], inner[:, :, -1]))]
            note = (f", border outputs below their inner neighbours "
                    f"{[round(v, 3) for v in lower]}")
            if min(lower) < 0.5:
                raise RuntimeError("the border case does not show the borders")
        print(f"K1 {label:12s} {(n, hh, ww, 1, cout)} body {plan.body} "
              f"({k1_plan_text(plan)}), max |out| {int(got.abs().max())}, "
              f"mismatches {mism}, second call differs at {repeat}{note}",
              flush=True)
        if plan.body != "stem":
            off_mma.append(label)
        max_err["conv3x3_int8"] = max(max_err["conv3x3_int8"], int(
            (got.int() - want.int()).abs().max()))
        bad += mism + repeat
        del x, wq, args, got, again, want
    if bad:
        raise RuntimeError(f"{bad} kernel outputs differ from plain")
    if off_mma:
        raise RuntimeError(f"K1 stages off their tensor-core body: {off_mma}")

    # ------------------------------------------------------------------ 3
    phase("3 graph: f=32, 10 classes, 512x512")
    model = cli.build_model(num_classes=NC, init_features=F, seed=SEED,
                            device=dev)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        # random BN terms, and 3x3 weights x1.75 so that activations do not
        # vanish and the labels are not all one class (at x2 the argmax
        # sits so near ties that the int8 contract has no margin left)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, init in ((m.weight, lambda t: t.uniform_(0.5, 1.5, generator=g)),
                                (m.bias, lambda t: t.normal_(0, 0.1, generator=g)),
                                (m.running_mean, lambda t: t.normal_(0, 0.1, generator=g)),
                                (m.running_var, lambda t: t.uniform_(0.5, 1.5, generator=g))):
                    t.copy_(init(torch.empty(t.shape)))
            elif isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3):
                m.weight.mul_(1.75)
    t0 = time.time()
    forward, calib = cli.build_psrp_forward(model, image_size=HW, device=dev,
                                            seed=SEED)
    print(f"fold + calibrate (TF32 off) + quantize: {time.time() - t0:.1f} s")
    imgs = torch.tensor(
        np.random.default_rng(SEED + 2).standard_normal((8, HW, HW, 1)),
        dtype=torch.float32, device=dev,
    )
    with torch.inference_mode():
        x = preprocess(imgs)
        lab = unet_psrp_forward(calib["qparams"], x, NC)
        lab_plain = unet_psrp_forward(calib["qparams"], x, NC, reference=True)
        q8 = tq.quantize_unet(calib["layers"], calib["taps"])
        ref8 = tq.unet_int8_forward(q8, x).argmax(-1)
        ref32 = tq.folded_forward(calib["layers"], x).argmax(-1)
    torch.cuda.synchronize()
    graph_mism = int((lab != lab_plain).sum())
    a8 = float((lab.long() == ref8).float().mean())
    a32 = float((lab.long() == ref32).float().mean())
    hist = torch.bincount(lab.flatten().long(), minlength=NC).tolist()
    print(f"labels {tuple(lab.shape)} {lab.dtype}, class histogram {hist}")
    print(f"kernel graph vs plain graph: {graph_mism} label mismatches")
    print(f"agreement vs all-int8 oracle {a8:.6f} (> 0.995), "
          f"vs float graph {a32:.6f} (> 0.95)", flush=True)
    if graph_mism or not (a8 > 0.995 and a32 > 0.95):
        raise RuntimeError("graph check failed")

    # ------------------------------------------------------------------ 4
    phase("4 serve: ServingLoop (batch 8) + HTTP, 12 requests, 3 clients")
    reqs = np.random.default_rng(SEED + 3).uniform(
        0, 255, (15, HW, HW, 1)
    ).astype(np.float32)
    with torch.inference_mode():
        direct = forward(torch.from_numpy(reqs).to(dev)).cpu().numpy()
    # 12 POSTs: 11 single B-scans and one batched request of 4
    posts = [reqs[i] for i in range(11)] + [reqs[11:15]]
    post_want = [direct[i] for i in range(11)] + [direct[11:15]]
    for k in wrappers.values():
        k.launches = 0
    loop = ServingLoop(forward, (HW, HW, 1), device=dev, batch_size=8,
                       max_wait_ms=5.0)
    loop.warmup()
    httpd, _ = start_in_background(loop, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(arr):
        return http_post(url, arr)

    results: dict[int, np.ndarray] = {}
    errors: list[BaseException] = []

    def client(idx):
        try:
            for i in idx:
                results[i] = post(posts[i])
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(range(c, 12, 3),))
               for c in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        # serve latency: one request at a time, warm
        lat = []
        for i in range(12):
            t0 = time.perf_counter()
            post(reqs[i % 15])
            lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.close()
    launches = {k: w.launches for k, w in wrappers.items()}
    if errors:
        raise RuntimeError(f"client errors: {errors!r}")
    ok = [np.array_equal(results[i], post_want[i]) for i in range(12)]
    n_fwd = loop.batches_run + 1  # + the warm-up batch
    print(f"healthz {health}")
    print(f"{sum(ok)}/12 responses equal the direct forward; "
          f"{loop.batches_run} batches + 1 warm-up")
    print(f"launches {launches}, expected {n_fwd} x "
          f"{LAUNCHES_PER_FORWARD}", flush=True)
    if not all(ok):
        raise RuntimeError("served labels differ from the direct forward")
    if any(launches[k] != n_fwd * v for k, v in LAUNCHES_PER_FORWARD.items()):
        raise RuntimeError("launch counts do not match the graph")

    # ------------------------------------------------------------------ 5
    phase(f"5 times on {card}")

    def time_ms(fn, runs=10):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(runs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out)

    totals = {k: [0.0, 0.0] for k in wrappers}
    bounds = {k: {"operations": 0.0, "bytes": 0.0} for k in wrappers}
    by_row = {}  # TPU kernel id -> [stages, kernel ms, plain ms, bound ms]
    # K1's 17 non-stem stages: the mma.sync body (event, device) against
    # the dp4a body at the same shape (event, device), and the bound
    k1 = {"ms": 0.0, "dev": 0.0, "dp4a": 0.0, "dp4a_dev": 0.0, "bound": 0.0}
    stem = {}  # the stem: the same, and the write-rate yardstick
    k1_rows = {}  # TPU kernel id -> [event ms, device ms]
    k1_slower = []
    k1_dev = 0.0  # K1's device time over every stage
    k1_plans = {}
    # K2's four calls: event and device time, bound, operations, bytes
    k2 = {"ms": 0.0, "dev": 0.0, "bound": 0.0, "ops": 0.0, "bytes": 0.0}
    k2_plans = {}
    k3_head = {}  # K3 at the head: event and device time, bound, plan
    for name, kernel, shape in stages():
        args, kw = stage_args(kernel, shape, 32)
        with torch.inference_mode():
            ms = time_ms(lambda: wrappers[kernel](*args, **kw))
            pms = time_ms(lambda: plains[kernel](*args, **kw))
        totals[kernel][0] += ms
        totals[kernel][1] += pms
        b_ms, b_by = bound(*serving_work(kernel, shape, 32), PEAK["int8"])
        bounds[kernel][b_by] += b_ms
        row = by_row.setdefault(tpu_row(name, kernel, shape),
                                [0, 0.0, 0.0, 0.0])
        for i, v in enumerate((1, ms, pms, b_ms)):
            row[i] += v
        extra = ""
        if kernel == "conv3x3_int8":
            plan = k1_plan(args)
            with torch.inference_mode():
                dms = device_ms(lambda: wrappers[kernel](*args, **kw))
                k1_dev += dms
                extra = (f" (device {dms:.4f}; body {plan.body}, "
                         f"{k1_plan_text(plan)})")
                d_ms = time_ms(lambda: k1_dp4a(args, kw))
                d_dms = device_ms(lambda: k1_dp4a(args, kw))
                same = all(torch.equal(a, b) for a, b in zip(
                    as_tuple(k1_dp4a(args, kw)),
                    as_tuple(wrappers[kernel](*args, **kw))))
                if not same:
                    raise RuntimeError(f"K1's bodies differ at {name}")
                r = k1_rows.setdefault(tpu_row(name, kernel, shape),
                                       [0.0, 0.0])
                r[0] += ms
                r[1] += dms
                k1_plans[name.split()[-1]] = (
                    f"stem N{plan.co_t} grid {plan.grid}"
                    if plan.body == "stem" else
                    f"{plan.body} N{plan.co_t} w{plan.warps} s{plan.stages}")
                if dms >= d_dms:
                    k1_slower.append(name)
                extra += (f", dp4a body {d_ms:.4f} ms (device "
                          f"{d_dms:.4f}; bit-equal)")
                if name.startswith("stem"):
                    zero = torch.empty_like(as_tuple(
                        wrappers[kernel](*args, **kw))[0])
                    z_dms = device_ms(lambda: zero.zero_())
                    nbytes = serving_work(kernel, shape, 32)[1]
                    stem.update(ms=ms, dev=dms, dp4a=d_ms, dp4a_dev=d_dms,
                                bound=b_ms, zero=z_dms, bytes=nbytes)
                    extra += (f"; {100 * b_ms / dms:.2f}% of the bound's "
                              f"rate, {nbytes / dms / 1e6:.1f} GB/s; "
                              f"zero_() of the output's shape (write-rate "
                              f"yardstick) device {z_dms:.4f} ms")
                    del zero
                else:
                    for key, v in (("ms", ms), ("dev", dms), ("dp4a", d_ms),
                                   ("dp4a_dev", d_dms), ("bound", b_ms)):
                        k1[key] += v
        if kernel == "ct2x2_int8":
            with torch.inference_mode():
                dms = device_ms(lambda: wrappers[kernel](*args, **kw))
            ops, nbytes = serving_work(kernel, shape, 32)
            for key, v in (("ms", ms), ("dev", dms), ("bound", b_ms),
                           ("ops", ops), ("bytes", nbytes)):
                k2[key] += v
            k2_plans[name] = k2_plan_text(args)
            extra = (f" (device {dms:.4f}; {100 * b_ms / dms:.2f}% of the "
                     f"bound's rate, {nbytes / dms / 1e6:.1f} GB/s, "
                     f"{ops / dms / 1e9:.1f} TOPS; plan {k2_plans[name]})")
        if kernel == "head_argmax":
            with torch.inference_mode():
                dms = device_ms(lambda: wrappers[kernel](*args, **kw))
            nbytes = serving_work(kernel, shape, 32)[1]
            k3_head.update(ms=ms, dev=dms, bound=b_ms, bytes=nbytes,
                           plan=k3.launch_plan(args[0], NC).text())
            extra = (f" (device {dms:.4f}; {100 * b_ms / dms:.2f}% of the "
                     f"bound's rate, {nbytes / dms / 1e6:.1f} GB/s; plan "
                     f"{k3_head['plan']})")
        print(f"time b32 {name:16s} {kernel:13s} kernel {ms:.4f} ms"
              f"{extra}, plain {pms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        del args
        torch.cuda.empty_cache()
    for k, (ms, pms) in totals.items():
        print(f"time b32 {k} summed over the graph's stages: kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{sum(bounds[k].values()):.4f} ms {bounds[k]}")
    for row, (n_stages, ms, pms, b_ms) in sorted(by_row.items()):
        dev_note = (f" (device {k1_rows[row][1]:.4f})" if row in k1_rows
                    else "")
        print(f"time b32 TPU kernel {row} ({n_stages} launches per forward): "
              f"kernel {ms:.4f} ms{dev_note}, plain {pms:.4f} ms, bound "
              f"{b_ms:.4f} ms")
    print(f"time b32 K1's 17 non-stem stages: mma.sync body {k1['ms']:.4f} "
          f"ms (device {k1['dev']:.4f}), dp4a body {k1['dp4a']:.4f} ms "
          f"(device {k1['dp4a_dev']:.4f}), bound {k1['bound']:.4f} ms; "
          f"device ratio {k1['dev'] / k1['dp4a_dev']:.4f} (must <= 0.25), "
          f"{100 * k1['bound'] / k1['dev']:.2f}% of the bound's rate; "
          f"stages not faster than the dp4a body: {k1_slower or 'none'}",
          flush=True)
    print(f"time b32 K1's stem (stem body): event {stem['ms']:.4f} ms, "
          f"device {stem['dev']:.4f} ms (must <= 0.40, aim <= 0.165), "
          f"dp4a body event {stem['dp4a']:.4f} ms, device "
          f"{stem['dp4a_dev']:.4f} ms, {stem['dp4a_dev'] / stem['dev']:.2f}x "
          f"(must >= 8), bound {stem['bound']:.4f} ms, "
          f"{100 * stem['bound'] / stem['dev']:.2f}% of the bound's rate, "
          f"{stem['bytes'] / stem['dev'] / 1e6:.1f} GB/s; write-rate "
          f"yardstick zero_() {stem['zero']:.4f} ms "
          f"({stem['bytes'] / stem['zero'] / 1e6:.1f} GB/s)", flush=True)
    print(f"time b32 K2's four calls (ct0-ct3): event {k2['ms']:.4f} ms, "
          f"device {k2['dev']:.4f} ms, bound {k2['bound']:.4f} ms, "
          f"{100 * k2['bound'] / k2['dev']:.2f}% of the bound's rate, "
          f"{k2['bytes'] / k2['dev'] / 1e6:.1f} GB/s, "
          f"{k2['ops'] / k2['dev'] / 1e9:.1f} TOPS", flush=True)
    print(f"time b32 K3 at the U-Net head ({HW}x{HW}x{F} -> {NC}): event "
          f"{k3_head['ms']:.4f} ms, device {k3_head['dev']:.4f} ms (must < "
          f"0.15, aim <= 0.11), bound {k3_head['bound']:.4f} ms, "
          f"{100 * k3_head['bound'] / k3_head['dev']:.2f}% of the bound's "
          f"rate, {k3_head['bytes'] / k3_head['dev'] / 1e6:.1f} GB/s; plan "
          f"{k3_head['plan']}", flush=True)
    for n in (32, 128):
        xb = torch.tensor(
            np.random.default_rng(n).uniform(0, 255, (n, HW, HW, 1)),
            dtype=torch.float32, device=dev,
        )
        with torch.inference_mode():
            ms = time_ms(lambda: forward(xb))
        print(f"served forward (z-score + graph) batch {n}: {ms:.3f} ms, "
              f"{n / ms * 1e3:.1f} B-scans/s", flush=True)
        if n == 32:
            with torch.inference_mode():
                profile_breakdown(
                    lambda: forward(xb), 3, f"the served forward, batch {n}",
                    {"K1 mma.sync body": "conv3x3_int8_mma",
                     "K1 stem body": "conv3x3_int8_stem",
                     "K1 dp4a body": "conv3x3_int8_kernel",
                     "K2 ct2x2_int8": "ct2x2_int8",
                     "K3 head_argmax": "head_argmax"})
        del xb
        torch.cuda.empty_cache()
    print(f"serve latency, one B-scan per request (HTTP, batch-8 loop): "
          f"median {statistics.median(lat):.2f} ms, min {min(lat):.2f} ms")

    kernels = [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": "; ".join(REPLACES[k]), "launches": launches[k],
        "max_abs_err": max_err[k], "ms": totals[k][0],
        "plain_ms": totals[k][1],
        "bound_ms": sum(bounds[k].values()),
        "bound_by": max(bounds[k], key=bounds[k].get),
        **({"device_ms": k1_dev, "plan": k1_plans}
           if k == "conv3x3_int8" else {}),
        **({"device_ms": k2["dev"], "plan": k2_plans}
           if k == "ct2x2_int8" else {}),
        **({"device_ms": k3_head["dev"], "plan": k3_head["plan"]}
           if k == "head_argmax" else {}),
        # no single PyTorch call computes an int8 conv with requant (K1),
        # an int8 transposed conv with requant (K2) or head + argmax on
        # int8 (K3)
        "library_ms": None,
    } for k in wrappers]
    k456, trained = train_phases(dev, card, time_ms)
    kernels += k456
    k89 = fused_loss_phases(dev, card, time_ms)
    kernels += [relaynet_phases(dev, card, time_ms, http_post)] + k89
    kernels += infer_eval_phases(dev, card, time_ms, model, calib, by_row)
    kernels.append(sdnet_phases(dev, card, time_ms))
    kernels += int4_phases(dev, card, time_ms, model, calib)
    real_data_phase(dev, card)
    zoo_phase(dev, card, time_ms)
    zoo2_phase(dev, card, time_ms)
    zoo3_phase(dev, card, time_ms)
    parallel_phase(dev, card, time_ms, model, calib)
    packed_dp_phase(dev, card, trained)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
