#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version at the serving paths'
shapes, drives the serving-d1, parity and serving-d2 megasteps (v2,
int8c and f32), the per-image order predictors (eval/pipeline), the
Tester (eval/tester) and the Trainer (train/trainer) at full ResNet-50
width, the MiDaS / InstaDepthNet evaluation (models/midas, eval/disp) at
full ResNeXt-101 width, PCNet-M (models/unet, eval/amodal, its Tester
method and training) at full unet2 width, InstaDepthNet training
(train/algos, compat/) at full width, data-parallel training and pair
sharding (parallel/), the last modules (instance segmentation and the
convex-hull baseline of eval/amodal, the Mapillary reader under the
PCNet-M Trainer, models/legacy with its losses, utils/profiling), and
prints one JSON line for the kernels plus a final status line.

    python3 chip_smoke.py

The CPU references of every card-vs-CPU comparison (the CPU f64 and f32
steps, the CPU Tester, predictor, forward and megastep runs) run in a
pool of spawned worker processes beside the card's phases (RefPool:
REF_WORKERS workers at niceness 19 with an equal share of the cores in
torch threads each, stopped while the card's phases time anything). The
references that need only seeds and fixtures (phases 6, 8, 9, 10, 11)
start with the script; those of phases 3, 4, 5 and 7, which need what the
card built or centred, start as the phase builds it, and their
comparisons run after phase 11 (phase 12). Each phase prints its wall
seconds, the seconds this process spent in (or waiting for) CPU
references, the CPU seconds of this process, of the reference workers
and of its ended children, and the host's least available memory and
highest load; a `timing:` line before the last ones sums them, with each
reference job's seconds in its worker. A phase run alone (its pool
argument None) opens a pool of its own, so a script calling it keeps
its work under a main guard.

Phases (any failed check raises and the script exits nonzero):
  1. build the CUDA sources (instaorder_tpu_torch/csrc) with nvcc; print
     the build time and the card's name and power limit, and the host's
     core counts; set this process's malloc to reuse freed blocks
     (keep_freed_heap: the CPU references' large tensors would fault
     their pages in afresh; the pool's workers do the same);
  2. each kernel vs its plain version on the card, at the serving
     batch: the preps (5-channel with bf16 and with f32 output, RGB) on
     4 synthetic 480x640 scenes of 10 instances (180 pairs; the f32
     mode also on adversarial crops at out 72, 256 and 300 against the
     plain version on the CPU), the v2 bottleneck kernels on the
     activations the serving trunk hands them, the serving-d2 q8 stem
     (kernel 15's q8 mode, its own row) on its prepped batch, the bf16
     blocks and the bf16 stem on those of the parity trunk (the plain
     trunk's, call by call; 360 images, both directions); the int8c
     blocks and stems on the plain int8c trunks' activations (the d1
     model's 180 images through the NHWC kernels, the d2 model's 360
     through the double-width stem and the hwnc-named kernels), each
     equal to its plain version on every value; the f32 modes of the
     RGB prep (its own row, 0 differing values expected) and of kernels
     10-15 on the f32 parity trunk's activations (the folded f32 model,
     360 images; blocks within 2e-5 of max |plain| per chained block,
     the stem within 1e-5); the f32 modes of the v2 kernels 2-4, 6-9
     (and 2') and of the q8 stem (15') on the trunk of the v2 model
     quantized at compute_dtype=f32 (serving-d1's network and
     calibration; the v2 bars); all timed with CUDA events, the bf16 and
     f32 kernels beside the plain cuDNN chain the JAX default runs for
     the same block or stem (at f32 with TF32 off), and every bf16 / v2
     row beside its convolutions alone (`conv_only_ms`: bf16 conv2d,
     channels_last, no epilogues; a yardstick the port never calls);
  3. the megasteps (v2 and int8c models calibrated from seed 0 on their
     own prep; bf16 parity model from seed 0): serving-d1, parity with
     its default kernels, parity with identity,down,stem and the RGB
     prep kernel, serving-d2, serving-d2 with its default set and
     stem, serving-d1 --dtype int8c, serving-d2 --dtype int8c with
     hwnc,down,stem, the other feature sets, and --dtype f32 (serving-d1,
     parity with identity,down,stem and the RGB prep kernel, parity
     hwnc / stage / sstage; the launches reported under the [f32] rows).
     For each: launch counts per megastep, pairs/s, and the logits of a
     few pairs (both directions) against the plain path run on the CPU
     (within 2%, at f32 within 1e-5; the v2 error also over 12 pairs);
     for int8c also the trunk's int8 output equal to the plain int8c
     forward's on the same prepped tensor on the card, logits within
     1e-5 of max |logit|; then the v2 model at compute_dtype=f32 through
     apply_folded_v2 and apply_folded_v2_siamese with the default set,
     +stem, hwncp, hwncs,hwncs1 and identity,down1 (launches reported
     under the v2 [f32] rows, logits within 2% of the CPU's);
  4. the order predictors (eval/pipeline.py) on 4 synthetic 480x640
     scenes of 3, 7, 10 and 16 instances (pair buckets 8, 32, 64, 128):
     make_v2_predictor (a dual-head net; directions 1 and 2, and at
     compute_dtype=f32 with directions 2), make_int8_predictor,
     make_folded_predictor(bf16, identity,down,stem) and
     make_folded_predictor(f32, identity,down,stem; also the image,
     resize and orig modes), and the f32 one without kernels (the cuDNN
     f32 route, timed only); then the 3-class InstaOrderNet_d head (its
     head centred on the 7-instance scene, centre_depth_head) through
     the f32 and bf16 (identity,down,stem) folded, int8c and v2
     factories with infer_depth_order, and the dual head on the bf16
     stage, sstage and hwnc sets and on int8c hwnc,down,stem. For each:
     the launches of every infer call, the matrices (and logits) on the
     card against the same predictor moved to the CPU on the smallest
     scene (the depth-only head on the two smallest; its bf16 / v2
     matrices at the pairs whose log(top / next) exceeds 4x the logit
     error its bar allows on every pair), and the per-image ms
     of infer_occ_order at each bucket with images/s over the four
     scenes;
  5. the Tester (eval/tester.py, JAX's tools/test.py counterpart) on
     fixtures written by the port's data/synthetic.py (InstaOrder: 8
     images of 480x640, 6 instances each; COCOA and KINS at their default
     sizes), the native RLE codec loaded: InstaOrderNet_o (pairs all and
     nbor), OrderNet (3 and 4 classes), InstaOrderNet_d and
     InstaOrderNet_od on InstaOrder, InstaOrderNet_o on COCOA and KINS,
     each at full ResNet-50 width from seed 0 (kaiming; its heads
     centred and scaled on the fixture's pairs, centre_heads), saved
     with the port's save_state and loaded back through load_model; the
     heuristics area / yaxis / hull on InstaOrder (occlusion; depth:
     area, yaxis) and on KINS. Each runs through Tester(device=None)
     .run() on the card, where it launches no kernel (JAX's Tester
     reaches none: the unfolded f32 resnet.apply, cuDNN with TF32 off),
     and through the same Tester on the CPU over the first
     TESTER_CPU_IMAGES (2) images: ground truth and heuristic matrices
     equal everywhere, model matrices equal at every sure cell, the
     card's metrics over those images (first_tester_metrics) equal to
     the CPU's wherever no cell differs (so wherever every cell is sure);
     per-image ms on the card for each run, and the prediction's share;
  6. training (train/trainer.py, JAX's trainer.py counterpart) on the
     same InstaOrder fixture, every step autograd over cuDNN f32 (TF32
     off; JAX's training reaches no Pallas kernel, so no kernel launches
     here, checked): InstaOrderNet_o at its config.yaml's settings
     (experiments/InstaOrder/, read by cli/config.load_config:
     ResNet-50, 256^2 patches, batch 32, SGD lr 1e-3, wd 1e-4, fused
     siamese) through Trainer(device=None).train() for 4 steps, a
     checkpoint at 4, a new Trainer resuming it (start_iter 4, params
     equal) to 6, validate() finite, and the Tester on the step-6
     checkpoint; each of InstaOrderNet_o, OrderNet, OrderNet_ext,
     InstaOrderNet_d and _od (384^2 resize) 3 steps at its own settings,
     finite losses, every param leaf moved; one SGD step of _o and _od
     at full width on 4 pairs of the port's dataset on the card against
     the CPU's f64 step (every run following the CPU f64 run's ReLU
     branch and stem-pool argmaxes, the disagreements counted): loss
     within 1e-5 relative, each leaf's update within 1e-3 of its max
     |update on the CPU|, the new statistics within max(1e-5, 2x the
     CPU f32 run's own error) on each leaf (check_stats); for _o at
     256^2 and _od at 384^2, the
     Trainer's loader-fed batch and data ms over a steady window (20
     steps after 10) and its loader's ms a batch alone (10 after 2; _o
     also with process workers), the device step ms on a fixed batch
     (median of 10 after 3), pairs/s and peak memory;
  7. the MiDaS family (models/midas.py, eval/disp.py; JAX's path reaches
     no Pallas kernel, so no kernel launches here, checked): MidasNet,
     InstaDepthNet_d and _od at full width (ResNeXt-101 32x8d trunk,
     features 256, ResNet-50 order branches) from seed 0 through
     get_backbone, out_conv3's bias raised so that the disparity is
     positive on >= 99% of the pixels (positive_disparity); (a) the
     disparity at 384^2 (a fixture image as DisparityOrderPredictor
     prepares it) and of a 352x1216 KITTI crop, and the _d / _od depth
     and occlusion logits on 4 mask pairs, card against CPU on the same
     trees within 1e-5 of max |CPU|; (b) Tester.run()'s disparity route
     on the InstaOrder fixture (midas_pretrained; InstaDepthNet_d with
     disp_select_method median, pairs all and nbor, and mean), each net
     loaded through load_model from the port's save_state: the card's
     first 2 images against the CPU's, matrices equal at every sure cell
     (region depths more than 1e-3 apart, relative), metrics equal where
     no cell differs; (c) cli/test_disp on DIW (8 images), KITTI (4,
     375x1242) and NYU (2) fixtures on the card and on the CPU: WHDR equal
     where no annotated pair's disparities lie within 1e-4, the dense
     metrics within 1e-4 relative; (d) the MidasNet forward at 384^2 and
     352x1216 (median of 10 after 3, CUDA events, and their range; one
     traced forward's device-busy ms and idle share) and the _od forward
     at batch 12, peak memory, the head's first conv on its two routes
     (models/midas._conv_without_cudnn and cuDNN) at 1x192^2, 12x96^2
     and 12x192x608, the Tester's per-image ms and the prediction's
     share, eval_diw's and the dense evals' ms an image; (e) no
     hand-written kernel launched; (f) the phase's seconds. Its configs
     are the experiment YAMLs' (cli/config.load_config), on fixtures;
  8. PCNet-M (models/unet.py, eval/amodal.py, the Tester's
     PartialCompletionMask method, its training; JAX's path reaches no
     Pallas kernel, so no kernel launches here, checked), on the phase 5
     fixtures and the three experiments/*/pcnet_m configs: (a) unet2 at
     full width from seed 0 (xavier gain sqrt(2), so that every depth
     reaches the output), its outc moved so that the completion
     probabilities of the first image's eraser pixels straddle th = 0.1
     (centre_outc; a random UNet's are ~0.5 everywhere, every patch
     would complete to all ones), its logits on that image's 30 patches
     of 256^2 card vs CPU within 1e-5 of max |CPU| and the probabilities
     within a tenth of the sure margin (1e-4), the shares of eraser
     pixels above th and within the margin; a unet2res forward at batch
     2 (1e-5); (b) Tester.run() with PartialCompletionMask on InstaOrder
     (pairs all and nbor), COCOA and KINS, the net saved with the port's
     save_state and loaded through load_model, on the card and on the CPU
     (first 2 images): the same patches, matrices equal at every sure
     cell (pcnet_sure: a pair whose votes cannot cross with every eraser
     pixel within the margin flipped), the metrics equal where no cell
     differs; per-image ms and the prediction's share; (c) the InstaOrder
     config (unet2, 256^2, batch 32, SGD) through Trainer(device=None)
     .train(): 4 steps, a checkpoint, a new Trainer resuming it to 6,
     validate() finite, the Tester on the step-6 checkpoint; COCOA and
     KINS 3 steps each, finite losses, every leaf moved; (d) one SGD step
     at full width on 4 patches of the port's dataset, card against the
     CPU's f64 step, every run on the CPU f64 run's ReLU branch and pool
     argmaxes (the flips counted: exact ties, near ties, others): loss
     within 1e-5 relative, each leaf's update within 1e-3 of its max (a
     conv bias feeding a train-mode BatchNorm, gradient 0, on the tree's
     max), statistics as in phase 6; the step ms on a fixed batch of 32
     (median of 10 after 3), patches/s, peak memory, and the Trainer's
     loader-fed batch and data ms over a steady window (20 steps after
     10) and its loader alone; (e) no hand-written kernel launched, the
     phase's seconds;
  9. InstaDepthNet training (train/algos.make_insta_depth_net, the
     disparity losses, ops/morphology.binary_erosion, models/midas
     .apply_train, compat/; JAX's path reaches no Pallas kernel, so no
     kernel launches here, checked) on the phase 5 InstaOrder fixture
     and experiments/InstaOrder/InstaDepthNet_{d,od} (ResNeXt-101 32x8d
     trunk, features 256, ResNet-50 order branches, 384^2 resize, batch
     12, SGD lr 1e-5, wd 1e-4): (a) a full-width MidasNet state dict of
     seeded weights in the reference's names (tests/torch_ref.py's
     TorchMidasOracle, torch only) written with torch.save and given to
     the _od Trainer as pretrained_weight: every trunk and decoder leaf
     the file's, the branches at their init; (b) one SGD step of _d and
     of _od at full width on DEPTH_XDEV samples (1) of 384^2, card
     against the CPU's f64 step (the CPU f64 run's ReLU branch and pool
     argmaxes): loss within 1e-5 relative (without the violation count
     where a pixel lies within 1e-5 of its threshold), updates within
     1e-3, the statistics as in phase 6, the violation count equal where
     no pixel is near a threshold (else the flipped pixels printed), the
     CPU f32 run's distances beside, the reference worker's peak RSS;
     (c) the _d YAML through
     Trainer(device=None).train() at batch 12 (its pretrained_weight
     missing: the warning checked), 4 steps, a checkpoint, a new Trainer
     resuming to 6, validate() finite, the Tester's disparity route and
     eval_diw on the step-6 checkpoint, make_disp_forward on the oracle's
     .pt (compat) within 1e-5 of the torch module, _od 3 finite steps;
     (d) the _d step on a fixed batch of 12 (median of 10 after 3), peak
     memory, the Trainer's loader-fed batch and data ms over a steady
     window (10 steps after 5) and its loader alone; no hand-written
     kernel launched; the phase's seconds;
 10. data parallel (parallel/, the all-reduced train step, the Trainer's
     ranks, cli/train --n-devices, OrderPredictor(mesh=)): NCCL with two
     ranks on cuda:0 (it refuses a duplicate device: its answer printed);
     (a) two gloo ranks sharing cuda:0: InstaOrderNet_o at its YAML's
     settings (ResNet-50, 256^2, SGD, per-rank batch 32) through
     Trainer(mesh=...): 4 steps, a checkpoint from rank 0 alone, a new
     Trainer resuming it to 6, validate() finite, the ranks' params equal
     on every value; one data-parallel SGD step of 2 x 2 pairs on the
     card against the CPU's f64 one-device steps on the two shards
     averaged by hand (every run on the CPU f64 run's ReLU branch and
     pool argmaxes of its shard) at phase 6's bars; the world-2 step on a
     fixed batch (each rank 32 pairs) and the gloo all-reduce of the
     gradient bucket, timed; (b) one step through the NCCL path at world
     1 equal on every value to build_train_step without a mesh (cuDNN
     deterministic), the world-1 step and the NCCL all-reduce timed
     (beside one dist.all_reduce of a flat bucket of the same size); (c)
     make_v2_predictor (compute_dtype f32) and make_folded_predictor (f32,
     identity,down,stem) with mesh=[cuda:0, cuda:0] against the same
     predictors unsharded on phase 4's scenes: matrices equal, launches
     counted; (d) on two or more cards (at most 4): cli.train --n-devices
     over NCCL (4 steps, --auto-resume to 6, validate), (a)'s ranks and
     checks over NCCL, the predictors' mesh over the cards with every
     model kernel launched on every card; on one card (d) prints that it
     did not run; the phase's seconds;
 11. the last modules (eval/amodal, data/readers Mapillary, models/legacy,
     losses, utils/profiling; JAX's counterparts reach no Pallas kernel,
     so no kernel launches here, checked; phase_last_modules, which a
     driver may call alone): (a) infer_instseg with box prompts, without
     and with the dense CRF (ops/crf, on the host), of phase 8's moved
     unet2 on the first 2 images of the phase 5 InstaOrder fixture at
     128x160, card against CPU: probabilities within a tenth of the sure
     margin, masks equal wherever the CPU's (CRF-refined) probability
     lies more than the sure margin from th; infer_amodal_hull (hulls
     cover their masks) grounded and not; (b) the PCNet-M Trainer on a
     Mapillary fixture (data/synthetic.make_mapillary_fixture: 8 images
     of 192x256, 16-bit instance maps) through the InstaOrder pcnet_m
     YAML with dataset Mapillary: 3 finite steps that move every leaf;
     (c) the legacy nets at the reference's widths from seed 0:
     PConvUNet layer_size 7 at 512^2 (batch 1, image and mask), AE256
     and VAE32 at 256^2 (the VAE's noise fed in), both spectral-norm
     discriminators at 256^2 and the VGG16 extractor at 256^2 (batch
     2), eval and train forwards on the card against the CPU's f64 run
     of the same net (the card's f64 run within 1e-9 of max |f64| in
     train mode, where the net is f64 throughout; its f32 run within
     max(1e-5, k x the CPU f32 run's distance from f64), k 4 for a
     train-mode net with BatchNorm, whose f32 forward with cuDNN
     switched off is printed beside, else 2; the train mode's
     statistics, the discriminators' power-iteration vectors included,
     by check_stats at that factor), each eval forward timed with the
     port's StepTimer; inpainting_loss's gradient
     through a train-mode PConvUNet (layer_size 7) and VGG16 at 256^2
     against the CPU's f64 one (the card's f64 gradient within 1e-9 of
     each leaf's max; in f32 the loss within 1e-5 relative, each leaf
     within max(1e-3, 4x the CPU f32 run's error) of its max); one
     PConvUNet forward traced by utils/profiling.trace into a temporary
     directory (the device kernels and busy ms of its Chrome trace); the
     phase's seconds;
 12. the deferred comparisons of phases 3, 4, 5 and 7, each as its
     reference job ends;
 13. each stem row's achieved TFLOP/s (TOP/s) at its real K = 245, each
     f32 row's share of its 3xTF32 bound (495 TF32 TFLOP/s, three
     products a MAC, two for an int8 A: the row's bound_ms) and of the
     f32 peak, the f32 stem rows' share of their design's floor (the
     same method at the K the kernel issues, 288 at C = 5), the
     inventory's coverage line (every row of ops/inventory.KERNELS, one
     per JAX Pallas function and mode, held against its plain version in
     phase 2, else the script fails naming the missing rows), the
     `timing:` line, the card's line, the `kernels` JSON line, then
     {"ok": true, "device": {...}}.
Exits nonzero without a result when no CUDA device is present.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

from instaorder_tpu_torch.ops import inventory

SCENES = 4
INSTANCES = 10
HEIGHT, WIDTH = 480, 640
OUT = 256
PASSES = 1                      # serving-d1: 1-pass bf16 prep weights
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_PER_S = 989e12        # dense bf16 tensor-core peak
H100_INT8_PER_S = 1979e12       # dense int8 tensor-core peak
H100_F32_PER_S = 67e12          # f32 outside the tensor cores
H100_TF32_PER_S = 495e12        # dense TF32 tensor-core peak
PREP_FLOPS_PER_PIXEL = 3 * (4 * 4 + 4) * 2 + 12   # taps + epilogue
PREP = 'fused_prep_pairs'
# the 5-channel prep's f32-output mode (row 1''): its own entry in the
# kernels line, counted by PREP's wrapper
PREP_F32 = PREP + '[f32]'
STAGE = 'fused_bottleneck_i8v2_hwnc_stage'
DOWN = 'fused_bottleneck_down_s2_i8v2_hwnc'
IDEN = 'fused_bottleneck_i8v2_hwnc'
RGB = 'fused_prep_rgb'
IDEN16 = 'fused_bottleneck'
DOWN16 = 'fused_bottleneck_down'
STEM = 'fused_stem'
# kernel 15's q8 mode (Cout 128, the serving-d2 `stem` route): its own
# entry in the kernels line, counted by STEM's wrapper
STEMQ8 = STEM + '[q8]'
I8 = 'fused_bottleneck_int8'
D8 = 'fused_bottleneck_down_int8'
STEM8 = 'fused_stem_int8'
I8H = 'fused_bottleneck_int8_hwnc'
D8H1 = 'fused_bottleneck_down_int8_hwnc'
D8H2 = 'fused_bottleneck_down_s2_int8_hwnc'
HWNCP = 'fused_bottleneck_i8v2_hwncp_stage'
DOWN1H = 'fused_bottleneck_down_i8v2_hwnc'
IDENN = 'fused_bottleneck_i8v2'
DOWN1N = 'fused_bottleneck_down_i8v2'
STAGE16 = 'fused_bottleneck_stage'
SSTAGE16 = 'fused_bottleneck_stage_stream'
HWNC16 = 'fused_bottleneck_hwnc'
# kernel 2's down=False mode (an identity run): its own entry in the
# kernels line, counted by STAGE's wrapper
RUN = STAGE + '[down=False]'
# the f32 modes of kernels 5 and 10-15 (the folded model at --dtype f32,
# the f32 predictor): each its own entry, counted by the wrapper of the
# bf16 row of the same name
F32 = '[f32]'
IDEN32, DOWN32, STAGE32, SSTAGE32, HWNC32, STEM32, RGB32 = (
    n + F32 for n in (IDEN16, DOWN16, STAGE16, SSTAGE16, HWNC16, STEM, RGB))
F32_ROWS = (IDEN32, DOWN32, STAGE32, SSTAGE32, HWNC32, STEM32, RGB32)
# the f32 modes of the v2 kernels 2-4, 6-9 (and 2') and of the q8 stem
# (15'): the v2 model at compute_dtype=f32, its own rows, counted by the
# wrappers of the v2 rows of the same name
V2F32 = {n: n + F32 for n in (STAGE, RUN, DOWN, IDEN, HWNCP, DOWN1H, IDENN,
                              DOWN1N, STEMQ8)}
V2F32_ROWS = tuple(V2F32.values())
# not a kernel: the v2 plain-chain blocks of a megastep, counted too
PLAIN_V2 = 'plain v2 blocks'
# each row's CUDA source and the JAX line it replaces, from the port's
# inventory of its kernels (ops/inventory.py), which the report holds
# whole: every row of it must have been held against its plain version
SOURCES = {k: src for k, (src, _) in inventory.rows().items()}
REPLACES = {k: at for k, (_, at) in inventory.rows().items()}
# the megasteps: (name, profile, megastep keywords, launches per step;
# every other kernel must launch 0 times)
V2_LAUNCHES = {PREP: 1, STAGE: 1, DOWN: 3, IDEN: 10}
# pairs of the v2 megasteps whose logit error is printed beside the
# 4-pair bar (the boundary round() ties leave these paths the least room)
MARGIN_PAIRS = 12
KFEATS = ('identity', 'down', 'stem')
# the megastep whose stage launches are all kernel 2's down=False mode
HWNCS_STEP = 'serving-d1 +hwnc,down1,down2,hwncs,hwncs1'
# the megastep whose stem launch is kernel 15's q8 mode
STEMQ8_STEP = 'serving-d2 +hwnc,down2,hwncs1d,dirpack,stem'
MEGASTEPS = [
    ('serving-d1', 'serving-d1', {}, V2_LAUNCHES),
    ('parity', 'parity', {}, {IDEN16: 5}),
    ('parity+identity,down,stem+prep_rgb=pallas', 'parity',
     {'prep_rgb': 'pallas', 'use_pallas': KFEATS},
     {IDEN16: 5, DOWN16: 3, STEM: 1, RGB: 1}),
    ('serving-d2', 'serving-d2', {}, V2_LAUNCHES),
    (STEMQ8_STEP, 'serving-d2',
     {'use_pallas': ('hwnc', 'down2', 'hwncs1d', 'dirpack', 'stem')},
     dict(V2_LAUNCHES, **{STEM: 1})),
    ('serving-d1 --dtype int8c', 'serving-d1', {'dtype': 'int8c'},
     {PREP: 1, I8: 12, D8: 4}),
    ('serving-d2 --dtype int8c +hwnc,down,stem', 'serving-d2',
     {'dtype': 'int8c', 'use_pallas': ('hwnc', 'down', 'stem')},
     {PREP: 1, I8H: 12, D8H1: 1, D8H2: 3, STEM8: 1}),
    # the remaining feature sets of the root bench
    ('serving-d1 +hwnc,down2,hwncp,dirpack', 'serving-d1',
     {'use_pallas': ('hwnc', 'down2', 'hwncp', 'dirpack')},
     {PREP: 1, HWNCP: 1, DOWN: 3, IDEN: 10}),
    ('serving-d2 +hwnc,down2,hwncp,dirpack', 'serving-d2',
     {'use_pallas': ('hwnc', 'down2', 'hwncp', 'dirpack')},
     {PREP: 1, HWNCP: 1, DOWN: 3, IDEN: 10}),
    (HWNCS_STEP, 'serving-d1',
     {'use_pallas': ('hwnc', 'down1', 'down2', 'hwncs', 'hwncs1')},
     {PREP: 1, DOWN1H: 1, STAGE: 4, DOWN: 3}),
    ('serving-d1 +identity,down1,stem2,qpool', 'serving-d1',
     {'use_pallas': ('identity', 'down1', 'stem2', 'qpool')},
     {PREP: 1, DOWN1N: 1, IDENN: 5, PLAIN_V2: 10}),
    ('parity +hwnc', 'parity', {'use_pallas': ('hwnc',)}, {HWNC16: 5}),
    ('parity +stage', 'parity', {'use_pallas': ('stage',)}, {STAGE16: 2}),
    ('parity +sstage', 'parity', {'use_pallas': ('sstage',)},
     {SSTAGE16: 2}),
    # --dtype f32: the folded f32 model on the kernels' f32 modes (the
    # launches are counted by the bf16 rows' wrappers and reported under
    # the [f32] rows)
    ('serving-d1 --dtype f32', 'serving-d1', {'dtype': 'f32'},
     {PREP: 1, IDEN16: 5}),
    ('parity --dtype f32 +identity,down,stem +prep_rgb=pallas', 'parity',
     {'dtype': 'f32', 'prep_rgb': 'pallas', 'use_pallas': KFEATS},
     {RGB: 1, IDEN16: 5, DOWN16: 3, STEM: 1}),
    ('parity --dtype f32 +hwnc', 'parity',
     {'dtype': 'f32', 'use_pallas': ('hwnc',)}, {HWNC16: 5}),
    ('parity --dtype f32 +stage', 'parity',
     {'dtype': 'f32', 'use_pallas': ('stage',)}, {STAGE16: 2}),
    ('parity --dtype f32 +sstage', 'parity',
     {'dtype': 'f32', 'use_pallas': ('sstage',)}, {SSTAGE16: 2}),
]
# the f32 megasteps' logit bar against the plain path on the CPU (the
# same pair batch: the f32 preps equal their plain versions on every
# value; f32 sums in another order)
F32_LOGIT_BAR = 1e-5
# the v2 model at compute_dtype=f32 (quantize_folded_v2, the smoke cell's
# calibration) through apply_folded_v2 (d1) and apply_folded_v2_siamese
# (d2) on the smoke cell's pair batch in f32, per feature set: (name,
# use_pallas, launches per forward of the v2 rows' wrappers; every other
# kernel must launch 0 times). The launches are reported under the
# V2F32 rows.
V2F32_FORWARDS = [
    ('hwnc,down2,hwncs1d,dirpack', True, {STAGE: 1, DOWN: 3, IDEN: 10}),
    ('hwnc,down2,hwncs1d,dirpack,stem',
     ('hwnc', 'down2', 'hwncs1d', 'dirpack', 'stem'),
     {STEM: 1, STAGE: 1, DOWN: 3, IDEN: 10}),
    ('hwnc,down2,hwncp,dirpack', ('hwnc', 'down2', 'hwncp', 'dirpack'),
     {HWNCP: 1, DOWN: 3, IDEN: 10}),
    ('hwnc,down1,down2,hwncs,hwncs1',
     ('hwnc', 'down1', 'down2', 'hwncs', 'hwncs1'),
     {DOWN1H: 1, STAGE: 4, DOWN: 3}),
    ('identity,down1', ('identity', 'down1'),
     {DOWN1N: 1, IDENN: 5, PLAIN_V2: 10}),
]


def check(ok, what):
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {what}')


class PhaseClock:
    """The wall seconds of each phase of main and, within it, the seconds
    this process spent computing or awaiting CPU references (the CPU f64
    and f32 runs, the CPU Tester / predictor / forward references), by
    label. A reference outside any phase (a phase run alone) counts under
    its label only."""

    def __init__(self):
        self.phases = []            # [name, wall s, reference s]
        self.refs = {}              # label: s
        self.pool = {}              # label: a pool job's s in its worker
        self.workers = list         # the open pool's worker pids
        self._open = None
        self._host = [float('inf'), 0.0]    # the phase's least MemAvailable
        #                                   # (GiB) and highest 1-min load

    def watch(self, every=2.0):
        """Sample the host's available memory (/proc/meminfo) and 1-minute
        load average every `every` s in a daemon thread; each phase's
        line prints the least and the highest."""
        import threading

        def sample():
            while True:
                with open('/proc/meminfo') as f:
                    kib = next(int(line.split()[1]) for line in f
                               if line.startswith('MemAvailable:'))
                self._host[0] = min(self._host[0], kib / 2 ** 20)
                self._host[1] = max(self._host[1], os.getloadavg()[0])
                time.sleep(every)
        if os.path.exists('/proc/meminfo'):
            threading.Thread(target=sample, daemon=True).start()

    def _cpu(self):
        """CPU seconds (user + system) of this process, of the open
        reference pool's workers (/proc/<pid>/stat), and of this
        process's children that have ended (the ranks, nvcc)."""
        import resource
        pool = 0.0
        for pid in self.workers():
            try:
                with open(f'/proc/{pid}/stat') as f:
                    fields = f.read().rsplit(')', 1)[1].split()
                pool += (int(fields[11]) + int(fields[12])) / os.sysconf(
                    'SC_CLK_TCK')
            except (OSError, IndexError, ValueError):
                pass            # an ended worker, or no /proc
        me, ended = (sum(resource.getrusage(who)[:2]) for who in (
            resource.RUSAGE_SELF, resource.RUSAGE_CHILDREN))
        return me, pool, ended

    def begin(self, name):
        """End the open phase, if any, and start phase `name`."""
        self.end()
        self._open = [name, time.perf_counter(), 0.0, self._cpu()]
        self.phases.append(self._open)
        self._host = [float('inf'), 0.0]

    def end(self):
        """End the open phase: print its wall and reference seconds, the
        CPU seconds of this process, of the reference workers and of its
        ended children in it, the peak RSS so far and the host's extremes
        (watch)."""
        import resource
        row, self._open = self._open, None
        if row is None:
            return
        row[1] = time.perf_counter() - row[1]
        cpu = [b - a for a, b in zip(row.pop(), self._cpu())]
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        print(f'phase {row[0]}: {row[1]:.1f} s wall, {row[2]:.1f} s of it '
              f'in CPU references; CPU {cpu[0]:.1f} s here, {cpu[1]:.1f} s '
              f'in the reference workers, {cpu[2]:.1f} s in ended '
              f'children; peak RSS so far {rss:.1f} GiB; host: '
              f'least MemAvailable {self._host[0]:.1f} GiB, highest 1-min '
              f'load {self._host[1]:.1f}')

    @contextlib.contextmanager
    def ref(self, label):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.refs[label] = self.refs.get(label, 0.0) + dt
            if self._open is not None:
                self._open[2] += dt

    def line(self):
        """The `timing:` summary: each phase's wall and reference seconds,
        this process's reference seconds by label (computed here or
        awaited from the pool) and each pool job's seconds in its
        worker."""
        return 'timing: ' + json.dumps({
            'phases': {n: {'wall_s': round(w, 2), 'cpu_ref_s': round(r, 2)}
                       for n, w, r in self.phases},
            'total_s': round(sum(w for _, w, _ in self.phases), 2),
            'cpu_refs_s': {k: round(v, 2) for k, v in self.refs.items()},
            'pool_job_s': {k: round(v, 2) for k, v in self.pool.items()}})


CLOCK = PhaseClock()

# ---- the CPU references beside the card -------------------------------------
# The reference pool's spawned worker processes, each at an equal share of
# this process's cores in torch threads and at the lowest scheduling
# priority, stopped while the card's phases time anything (quiet()): the
# timings stay those of a quiet host, and the references take the cores
# the rest of the time.
REF_WORKERS = 4
# the longest the main process waits for one job: a worker that dies (the
# host out of memory) leaves its job unfinished, and the script fails
# instead of waiting out its own time limit
REF_TIMEOUT = 600


def ref_worker_init(threads, quiet):
    """A reference pool worker (spawned: a fresh interpreter): in a
    session of its own (a stopped worker never sits in the script's
    process group, which the kernel hangs up when that group is orphaned
    with a stopped member), no card visible (CUDA_VISIBLE_DEVICES empty,
    so a stray CUDA call raises), niceness 19, torch at `threads`
    intra-op threads, glibc's malloc keeping freed blocks
    (keep_freed_heap), the native RLE codec loaded as in the main
    process; it takes no job while the pool is quiet."""
    os.setsid()
    os.environ['CUDA_VISIBLE_DEVICES'] = ''
    os.nice(19)
    import torch
    from instaorder_tpu_torch import native
    torch.set_num_threads(threads)
    keep_freed_heap()
    native.load()           # the RLE codec the main process uses
    while quiet.is_set():
        time.sleep(0.05)


def run_ref(fn, args, path):
    """One reference job in a worker: fn(*args) pickled to file `path`
    (jobs return numpy arrays and Python values only; a file keeps the
    large ones out of the pool's pipes and the main process's result
    thread); then the worker's freed memory goes back to the system
    (glibc's malloc_trim: the worker takes the next job). Returns the
    job's seconds."""
    import ctypes
    import ctypes.util
    import gc
    import pickle
    import torch
    t0 = time.perf_counter()
    out = fn(*args)
    check(not torch.cuda.is_initialized(),
          f'{fn.__name__}: a reference worker stays off the card')
    with open(path, 'wb') as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    seconds = time.perf_counter() - t0
    del out
    gc.collect()
    ctypes.CDLL(ctypes.util.find_library('c') or 'libc.so.6').malloc_trim(0)
    return seconds


class RefPool:
    """The CPU references in spawned worker processes (multiprocessing,
    spawn context), computed while this process drives the card.
    submit() starts a job; result() waits for it (the wait counted by
    CLOCK as reference time), re-raising a job's exception so that its
    phase fails; later() defers a check of a job's result to finish(),
    which the context's exit runs; put() writes a job's large input to a
    file; paused() stops the workers. The context sets quiet() to
    paused(). On an exception the workers are terminated; either way the
    pool's files and tempdir()'s directories are removed."""

    def __init__(self, workers=REF_WORKERS):
        import itertools
        import multiprocessing
        ctx = multiprocessing.get_context('spawn')
        self.threads = max(1, len(os.sched_getaffinity(0)) // workers)
        self._quiet, self._depth = ctx.Event(), 0
        self._pool = ctx.Pool(workers, ref_worker_init,
                              (self.threads, self._quiet))
        self._jobs, self._later, self._dirs = {}, [], []
        self._files = self.tempdir()
        self._count = itertools.count()
        print(f'reference pool: {workers} spawned workers at niceness 19, '
              f'{self.threads} torch threads each')

    def submit(self, label, fn, *args):
        """Start job `label` = fn(*args) in a worker (once)."""
        if label not in self._jobs:
            path = os.path.join(self._files, f'out{next(self._count)}.pkl')
            self._jobs[label] = (self._pool.apply_async(
                run_ref, (fn, args, path)), path)
        return label

    def result(self, label, fn=None, *args):
        """Job `label`'s result, submitting fn(*args) first if it is not
        running yet."""
        import pickle
        if fn is not None:
            self.submit(label, fn, *args)
        job, path = self._jobs.pop(label)
        with CLOCK.ref(label):
            CLOCK.pool[label] = job.get(REF_TIMEOUT)
            with open(path, 'rb') as f:
                out = pickle.load(f)
        os.remove(path)
        return out

    def put(self, torch, obj):
        """obj written with torch.save to a file of the pool (any tensor
        dtype, bf16 included, and module-level functions): a job's input,
        which the job reads with torch.load. Returns the path."""
        path = os.path.join(self._files, f'in{next(self._count)}.pt')
        torch.save(obj, path)
        return path

    def later(self, label, fn, *args, then):
        """Start job `label` = fn(*args); finish() calls then(its
        result)."""
        self.submit(label, fn, *args)
        self._later.append((label, then))

    def tempdir(self):
        """A directory that lives until the pool closes (for a job's
        files)."""
        import tempfile
        self._dirs.append(tempfile.mkdtemp(prefix='chip_smoke_'))
        return self._dirs[-1]

    def finish(self):
        """Every deferred check, in the order deferred."""
        while self._later:
            label, then = self._later.pop(0)
            then(self.result(label))

    @contextlib.contextmanager
    def paused(self):
        """Every worker stopped (SIGSTOP) inside the block, and a worker
        started meanwhile waits before its first job: the block runs on a
        host without the references. Nests."""
        import signal
        self._depth += 1
        if self._depth == 1:
            self._quiet.set()
            self._stopped = list(self._pool._pool)
            for p in self._stopped:
                signal_process(p.pid, signal.SIGSTOP)
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._quiet.clear()
                for p in self._stopped:
                    signal_process(p.pid, signal.SIGCONT)

    def __enter__(self):
        global QUIET
        self._outer, QUIET = QUIET, self.paused
        self._workers, CLOCK.workers = CLOCK.workers, lambda: [
            p.pid for p in self._pool._pool]
        return self

    def __exit__(self, kind, value, tb):
        import shutil
        global QUIET
        QUIET, CLOCK.workers = self._outer, self._workers
        try:
            if kind is None:
                self.finish()
                self._pool.close()
            else:
                self._pool.terminate()
            self._pool.join()
        finally:
            for d in self._dirs:
                shutil.rmtree(d, ignore_errors=True)


def signal_process(pid, sig):
    """os.kill(pid, sig); a process that has ended is left alone."""
    try:
        os.kill(pid, sig)
    except ProcessLookupError:
        pass


# the open RefPool's paused(), else a no-op: quiet() around every timing
QUIET = contextlib.nullcontext


def quiet():
    """The reference workers stopped inside the block (RefPool.paused),
    where there is an open pool."""
    return QUIET()


def own_pool(pool):
    """`pool`, or, for a phase run alone (pool None), a RefPool of its
    own that finishes with the phase."""
    return contextlib.nullcontext(pool) if pool is not None else RefPool()


def host_tree(x):
    """A tree of tensors (dicts, lists, tuples) as numpy, its structure
    kept: a job's result or a branch sent between processes."""
    if isinstance(x, dict):
        return {k: host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host_tree(v) for v in x)
    if hasattr(x, 'detach'):
        return x.detach().cpu().numpy()
    return x


def torch_tree(torch, x):
    """host_tree's inverse: numpy arrays as CPU tensors."""
    import numpy as np
    if isinstance(x, dict):
        return {k: torch_tree(torch, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(torch_tree(torch, v) for v in x)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return x


def keep_freed_heap():
    """This process's glibc malloc set to keep freed blocks for reuse:
    by default it maps every block above a threshold (at most 32 MiB)
    afresh and unmaps it when freed, so each large tensor of the CPU
    references (the Tester's, the f64 steps') faults its pages in and
    zeroes them again, and the eager CPU ops spend more time on that than
    on their arithmetic. Blocks up to 1 GiB come from the heap, whose
    top is returned to the system above 2 GiB free. Returns whether
    glibc took both settings (False where there is no glibc)."""
    import ctypes
    import ctypes.util
    M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
    try:
        libc = ctypes.CDLL(ctypes.util.find_library('c') or 'libc.so.6')
        return bool(libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
                    and libc.mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1))
    except (OSError, AttributeError):
        return False


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, reps=5):
    """Mean device time of fn over reps launches (after one warm-up)."""
    with quiet():
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def diff(torch, what, got, want):
    """Max |got - want| and the share of differing values, printed."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f'{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} '
          f'{tuple(want.shape)}')
    d = (got.float() - want.float()).abs()
    err, frac = float(d.max()), float((d > 0).float().mean())
    print(f'{what}: max |kernel - plain| {err} on {frac:.2e} of values')
    return err, frac


def bf16_diff(torch, what, got, want, share=0.01):
    """diff() plus the bf16 bars: max |kernel - plain| <= 1e-2 max |plain|
    and under `share` of the values more than one bf16 ulp apart."""
    err, _ = diff(torch, what, got, want)
    w = want.float()
    d = (got.float() - w).abs()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    far = float((d > ulp).float().mean())
    scale = float(w.abs().max())
    print(f'  {far:.2e} of values more than one bf16 ulp apart; '
          f'max |plain| {scale}')
    check(err <= 1e-2 * scale and far < share,
          f'{what}: within 1e-2 of max |plain|, <{share} beyond one ulp')
    live = float((w != 0).float().mean())
    check(live > 0.05, f'{what}: {live:.3f} of outputs nonzero')
    return err


def conv_only_ms(torch, shape, blocks):
    """The yardstick beside a bf16 / v2 row: device ms of the blocks'
    convolutions alone (torch.nn.functional.conv2d in bf16,
    channels_last; no bias, activation, residual or rounding) at the
    row's shapes, chained as the call chains its blocks. The port never
    calls it. blocks: [(block params, stride)]; shape (N, H, W, Cin)."""
    F = torch.nn.functional
    cl = torch.channels_last
    t = lambda *s: torch.randn(*s, device='cuda', dtype=torch.bfloat16
                               ).to(memory_format=cl)
    n, h, w, cin = shape
    x = t(n, cin, h, w)
    convs = []
    for blk, stride in blocks:
        cm, cout = blk['conv1']['w'].shape[-1], blk['conv3']['w'].shape[-1]
        convs.append((t(cm, cin, 1, 1), t(cm, cm, 3, 3), t(cout, cm, 1, 1),
                      t(cout, cin, 1, 1) if 'down' in blk else None, stride))
        cin = cout

    def run():
        h = x
        for w1, w2, w3, wd, stride in convs:
            o = F.conv2d(F.conv2d(F.conv2d(h, w1), w2, stride=stride,
                                  padding=1), w3)
            if wd is not None:
                F.conv2d(h, wd, stride=stride)
            h = o
    return cuda_ms(torch, run)


def block_macs(shape, blk, stride):
    """MACs of one bottleneck on an (N, H, W, Cin) input: conv1 at the
    input resolution, conv2/conv3/projection at the output resolution."""
    n, h, w, cin = shape
    cm, cout = blk['conv1']['w'].shape[-1], blk['conv3']['w'].shape[-1]
    ho, wo = h // stride, w // stride
    macs = n * h * w * cin * cm + n * ho * wo * (9 * cm * cm + cm * cout)
    if 'down' in blk:
        macs += n * ho * wo * cin * cout
    return macs, (n, ho, wo, cout)


def tf32x3_ops(shape, blocks, x_int8):
    """TF32 tensor-core operations of the f32 block kernel's 3xTF32 method
    over `blocks` [(block params, stride)] chained from an (N, H, W, Cin)
    input: three products a MAC, two where the A operand is int8 (x_int8:
    one flag a block, True where its x, read by conv1 and the projection,
    is int8)."""
    ops = 0
    for (blk, stride), i8 in zip(blocks, x_int8, strict=True):
        n, h, w, cin = shape
        cm, cout = blk['conv1']['w'].shape[-1], blk['conv3']['w'].shape[-1]
        ho, wo = h // stride, w // stride
        x_macs = n * h * w * cin * cm
        if 'down' in blk:
            x_macs += n * ho * wo * cin * cout
        ops += 2 * ((2 if i8 else 3) * x_macs
                    + 3 * n * ho * wo * (9 * cm * cm + cm * cout))
        shape = (n, ho, wo, cout)
    return ops


def trunk_calls(q, BK, FO):
    """The trunk's kernel calls in _apply_trunk_v2's order: (name,
    kernel(h), plain(h), [(block params, stride)] it covers)."""
    l1 = q['layer1']
    down = FO._kernel_args(l1[0])
    run = [FO._kernel_args(b) for b in l1[1:]]
    rs = [b['r'] for b in l1[1:]]
    wks = [b.get('wk') for b in l1]
    yield (STAGE, lambda h: BK.fused_bottleneck_i8v2_stage(h, down, run, rs,
                                                           wk=wks),
           lambda h: BK.fused_bottleneck_i8v2_stage_plain(h, down, run, rs),
           [(b, 1) for b in l1])
    rest = [qb for li in (2, 3, 4) for qb in q[f'layer{li}']]
    for i, qb in enumerate(rest):
        o = i + 1 == len(rest)          # int8 out at the trunk's end only
        a, wk = FO._kernel_args(qb), qb.get('wk')
        if 'down' in qb:
            yield (DOWN,
                   lambda h, a=a, o=o, wk=wk: BK.fused_bottleneck_i8v2_down_s2(
                       h, *a, out_int8=o, wk=wk),
                   lambda h, a=a, o=o: BK.fused_bottleneck_i8v2_down_s2_plain(
                       h, *a, out_int8=o), [(qb, 2)])
        else:
            a = (*a, qb['r'])
            yield (IDEN,
                   lambda h, a=a, o=o, wk=wk:
                   BK.fused_bottleneck_i8v2_identity(h, *a, out_int8=o,
                                                     wk=wk),
                   lambda h, a=a, o=o: BK.fused_bottleneck_i8v2_identity_plain(
                       h, *a, out_int8=o), [(qb, 1)])


def check_stage_blocks(torch, BK, FO, blocks, h):
    """Each block of a stage (a list of block params) on the plain
    stage's input: the one-block bar holds per block. Over the whole
    stage a tie flip in one block's output moves the next block's input,
    so the stage's own bar is one LSB per chained block."""
    for j, qb in enumerate(blocks):
        w = FO._kernel_args(qb)
        kw = ({'wd': w[6], 'bd': w[7]} if 'down' in qb else {'r': qb['r']})
        w = w[:6]
        want = BK._block_plain(h, *w, **kw)
        err, frac = diff(torch, f'  stage block {j}',
                         BK._block_cuda(h, *w, **kw, wk=qb.get('wk')), want)
        check(err <= 1 and frac < 0.01, f'stage block {j}: <=1 LSB on <1%')
        h = want
    return len(blocks)


def n_differing(got, want):
    return int((got.float() != want.float()).sum())


def phase_prep(torch, PK, prep_args, n_pairs):
    """The 5-channel prep kernel at passes 1 (serving-d1, the row) and 3
    (serving-d2); each prints its number of differing values."""
    for passes in (3, PASSES):
        x_k = PK.fused_prep_pairs(*prep_args, out_size=OUT, passes=passes)
        x_p = PK.fused_prep_pairs_plain(*prep_args, out_size=OUT,
                                        passes=passes)
        torch.cuda.synchronize()
        check(bool((x_k[..., :2] == x_p[..., :2]).all()), 'prep masks exact')
        err, frac = diff(torch, f'{PREP} passes={passes} (RGB)',
                         x_k[..., 2:], x_p[..., 2:])
        n_mask = n_differing(x_k[..., :2], x_p[..., :2])
        n_rgb = n_differing(x_k[..., 2:], x_p[..., 2:])
        print(f'{PREP} passes={passes}: {n_mask} differing mask values, '
              f'{n_rgb} differing RGB values')
        check(err <= 0.03125 + 1e-6 and frac < 0.01,
              'prep RGB within one uint8 LSB on <1% of pixels')
    result = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: PK.fused_prep_pairs(
            *prep_args, out_size=OUT, passes=PASSES)),
        plain_ms=cuda_ms(torch, lambda: PK.fused_prep_pairs_plain(
            *prep_args, out_size=OUT, passes=PASSES), reps=2),
        bytes=nbytes(x_k, *prep_args),
        ops=n_pairs * OUT * OUT * PREP_FLOPS_PER_PIXEL,
        ops_rate=H100_F32_PER_S)
    return x_k, result


def adversarial_rois(torch, out_size, w):
    """(2, 9, 4) xywh crops of 1, 2, 3, out/2, out, 3*out and 5*out
    pixels, negative offsets, one wholly outside the image, one not
    square (the same sizes at other offsets on scene 1)."""
    o = out_size
    r0 = [[3, 4, 1, 1], [-1, 7, 2, 2], [w - 2, -2, 3, 3],
          [5, 9, o // 2, o // 2], [-6, -5, o, o], [-20, -11, 3 * o, 3 * o],
          [-30, -40, 5 * o, 5 * o], [w + 5, -300, o, o], [3, 2, 7, 45]]
    r1 = [[x + 2 * i - 5, y - i, sx, sy]
          for i, (x, y, sx, sy) in enumerate(r0)]
    return torch.tensor([r0, r1], dtype=torch.float32)


def phase_prep_f32(torch, PK, serving, prep_args, x_bf16_1, n_pairs):
    """Row 1'': the 5-channel prep with f32 output (OrderPredictor's
    default prep dtype) at passes 3 and 1, against its plain version on
    the card (0 differing values) and against the bf16 mode (the same
    values, rounded); then on odd image sizes and adversarial crops at
    out 72, 256 and 300 against the plain version run on the CPU (the
    card's PyTorch divides by a Python scalar as a multiply by the
    reciprocal, which moves rare taps where out is not a power of
    two). The row reports passes 3, the predictor's default."""
    f32 = torch.float32
    for passes in (1, 3):
        x_k = PK.fused_prep_pairs(*prep_args, out_size=OUT, passes=passes,
                                  out_dtype=f32)
        x_p = PK.fused_prep_pairs_plain(*prep_args, out_size=OUT,
                                        passes=passes, out_dtype=f32)
        err, _ = diff(torch, f'{PREP_F32} passes={passes}', x_k, x_p)
        n = n_differing(x_k, x_p)
        print(f'{PREP_F32} passes={passes}: {n} differing values')
        check(n == 0, f'{PREP_F32}: 0 differing values')
        check(bool(((x_k[..., :2] == 0) | (x_k[..., :2] == 1)).all()),
              f'{PREP_F32}: masks exactly 0 or 1')
        if passes == PASSES:
            check(torch.equal(x_k.bfloat16(), x_bf16_1),
                  f'{PREP_F32}: rounded to bf16, the bf16 mode')
    dev = prep_args[0].device
    images, masks, _ = serving.synthetic_scenes(2, 131, 203, 4, seed=11)
    sc = (torch.as_tensor(images, device=dev),
          torch.as_tensor(masks, device=dev).to(torch.uint8))
    pidx = torch.tensor([[0, 1], [2, 3], [1, 0], [3, 3], [0, 2], [1, 3],
                         [2, 1], [3, 0], [0, 0]], dtype=torch.int32,
                        device=dev)
    for out_size in (72, 256, 300):
        rois = adversarial_rois(torch, out_size, 203).to(sc[0].device)
        host = [t.cpu() for t in (sc[0], sc[1], pidx, rois)]
        for passes in (1, 3):
            got = PK.fused_prep_pairs(sc[0], sc[1], pidx, rois,
                                      out_size=out_size, passes=passes,
                                      out_dtype=f32)
            want = PK.fused_prep_pairs_plain(*host, out_size=out_size,
                                             passes=passes, out_dtype=f32)
            n = n_differing(got.cpu(), want)
            print(f'{PREP_F32} adversarial out={out_size} passes={passes}: '
                  f'{n} differing values (plain on the CPU)')
            check(n == 0, f'{PREP_F32} adversarial: 0 differing values')
    x_k = PK.fused_prep_pairs(*prep_args, out_size=OUT, passes=3,
                              out_dtype=f32)
    return dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: PK.fused_prep_pairs(
            *prep_args, out_size=OUT, passes=3, out_dtype=f32)),
        plain_ms=cuda_ms(torch, lambda: PK.fused_prep_pairs_plain(
            *prep_args, out_size=OUT, passes=3, out_dtype=f32), reps=2),
        bytes=nbytes(x_k, *prep_args),
        ops=n_pairs * OUT * OUT * PREP_FLOPS_PER_PIXEL,
        ops_rate=H100_F32_PER_S)


def phase_prep_rgb(torch, PK, images, rois, n_pairs):
    """The RGB prep kernel at passes 1 and 3 (the parity path's --prep-rgb
    pallas), normalised and raw; the row reports passes 3 normalised.
    Each setting prints its number of differing values."""
    for normalize in (False, True):
        for passes in (1, 3):
            x_k = PK.fused_prep_rgb(images, rois, out_size=OUT,
                                    normalize=normalize, passes=passes)
            x_p = PK.fused_prep_rgb_plain(images, rois, out_size=OUT,
                                          normalize=normalize, passes=passes)
            err, frac = diff(torch, f'{RGB} passes={passes} '
                             f'normalize={normalize}', x_k, x_p)
            print(f'{RGB} passes={passes} normalize={normalize}: '
                  f'{n_differing(x_k, x_p)} differing values')
            lsb = 0.03125 if normalize else 1.0
            check(err <= lsb + 1e-6 and frac < 0.01,
                  'prep RGB within one uint8 LSB on <1% of pixels')
    return dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: PK.fused_prep_rgb(images, rois,
                                                    out_size=OUT)),
        plain_ms=cuda_ms(torch, lambda: PK.fused_prep_rgb_plain(
            images, rois, out_size=OUT), reps=2),
        chain_ms=cuda_ms(torch, lambda: rgb_einsum(torch, images, rois),
                         reps=2),
        bytes=nbytes(x_k, images, rois),
        ops=n_pairs * OUT * OUT * PREP_FLOPS_PER_PIXEL,
        ops_rate=H100_F32_PER_S)


def rgb_einsum(torch, images, rois, dtype=None):
    """The RGB half of the parity profile's einsum prep (the JAX default
    route): two dense interpolation matmuls batched over the scenes,
    round, clip, normalise; written in `dtype` (bf16 by default)."""
    from instaorder_tpu_torch.ops import pairs as P
    return P._rgb_pair_batch(images, rois, OUT).to(
        dtype or torch.bfloat16).reshape(-1, OUT, OUT, 3)


def phase_prep_rgb_f32(torch, PK, images, rois, n_pairs):
    """Kernel 5's f32-output mode (the f32 parity path's --prep-rgb
    pallas) at passes 1 and 3, normalised and raw, against its plain
    version on the card (one uint8 LSB on under 1% of pixels; each
    setting prints its number of differing values) and, once rounded,
    equal to the bf16 mode. The row reports passes 3 normalised, beside
    the einsum prep's RGB half written in f32."""
    f32 = torch.float32
    for normalize in (False, True):
        for passes in (1, 3):
            kw = dict(out_size=OUT, normalize=normalize, passes=passes)
            x_k = PK.fused_prep_rgb(images, rois, out_dtype=f32, **kw)
            x_p = PK.fused_prep_rgb_plain(images, rois, out_dtype=f32, **kw)
            err, frac = diff(torch, f'{RGB32} passes={passes} '
                             f'normalize={normalize}', x_k, x_p)
            print(f'{RGB32} passes={passes} normalize={normalize}: '
                  f'{n_differing(x_k, x_p)} differing values')
            lsb = 1.0 / (255 * 0.224) if normalize else 1.0
            check(err <= lsb + 1e-6 and frac < 0.01,
                  f'{RGB32}: within one uint8 LSB on <1% of pixels')
            check(torch.equal(x_k.bfloat16(),
                              PK.fused_prep_rgb(images, rois, **kw)),
                  f'{RGB32}: rounded to bf16, the bf16 mode')
    return dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: PK.fused_prep_rgb(
            images, rois, out_size=OUT, out_dtype=f32)),
        plain_ms=cuda_ms(torch, lambda: PK.fused_prep_rgb_plain(
            images, rois, out_size=OUT, out_dtype=f32), reps=2),
        chain_ms=cuda_ms(torch, lambda: rgb_einsum(torch, images, rois, f32),
                         reps=2),
        bytes=nbytes(x_k, images, rois),
        ops=n_pairs * OUT * OUT * PREP_FLOPS_PER_PIXEL,
        ops_rate=H100_F32_PER_S)


def stem_ops(x, w):
    """Operations of a stem conv at its real K = 7 * 7 * C (not the
    kernel's padded K): 2 * N * Hc * Wc * K * Cout."""
    n, hc, wc = x.shape[0], (x.shape[1] + 1) // 2, (x.shape[2] + 1) // 2
    return 2 * n * hc * wc * w[..., 0].numel() * w.shape[-1]


def f32_stem_floor_ops(SK, x, w):
    """TF32 operations of the f32 stem kernel's own design: three
    products a MAC at its K (the s2d k8 steps it issues, 288 at C = 5,
    SK.f32_stem_steps), not the real K = 245 of the row's bound."""
    k = 8 * len(SK.f32_stem_steps(w.shape[2]))
    return 3 * stem_ops(x, w) * k // w[..., 0].numel()


def phase_stem_q8(torch, SK, FO, q, x, results, f32=False):
    """Row 15': the serving-d2 route's q8 stem (double width, Cout 128)
    vs its plain version, both timed; f32: row 15'[f32], the q8 stem of
    the v2 model at compute_dtype=f32 on x in f32."""
    name = V2F32[STEMQ8] if f32 else STEMQ8
    c1 = FO.siamese_conv1(q['conv1'])
    x = (x.float() if f32 else x).contiguous()
    kern = lambda: SK.fused_stem(x, c1['w'], c1['b'], q8=True, wk=c1['wk'])
    want = SK.fused_stem_plain(x, c1['w'], c1['b'], q8=True)
    err, frac = diff(torch, f'{name} {tuple(x.shape)}->'
                     f'{tuple(want.shape)}', kern(), want)
    check(err <= 1 and frac < 0.01, f'{name}: <=1 LSB on <1%')
    live = float(((want > 0) & (want < 127)).float().mean())
    check(live > 0.05, f'{name}: {live:.3f} of outputs unclipped')
    add_row(results, name, err, cuda_ms(torch, kern),
            cuda_ms(torch, lambda: SK.fused_stem_plain(
                x, c1['w'], c1['b'], q8=True), reps=2), None,
            nbytes(x, want, c1['w'], c1['b']), stem_ops(x, c1['w']),
            rate=H100_F32_PER_S if f32 else H100_BF16_PER_S,
            tf32_ops=3 * stem_ops(x, c1['w']) if f32 else None,
            floor_ops=f32_stem_floor_ops(SK, x, c1['w']) if f32 else None)


def add_row(results, name, err, kern, plain, chain, nbytes_, ops,
            rate=H100_BF16_PER_S, conv_only=None, tf32_ops=None,
            floor_ops=None):
    """Add one call's numbers to the kernel's row (chain: the cuDNN
    route's ms, conv_only: conv_only_ms(), tf32_ops: the TF32 operations
    of the f32 kernels' 3xTF32 method, floor_ops: those of the f32 stem
    kernel at its own K; None where the row has no such column)."""
    r = results.setdefault(name, dict(
        max_abs_err=0.0, ms=0.0, plain_ms=0.0, bytes=0, ops=0,
        ops_rate=rate))
    r['max_abs_err'] = max(r['max_abs_err'], err)
    r['ms'] += kern
    r['plain_ms'] += plain
    if chain is not None:
        r['chain_ms'] = r.get('chain_ms', 0.0) + chain
    if conv_only is not None:
        r['conv_only_ms'] = r.get('conv_only_ms', 0.0) + conv_only
    if tf32_ops is not None:
        r['tf32_ops'] = r.get('tf32_ops', 0) + tf32_ops
    if floor_ops is not None:
        r['floor_ops'] = r.get('floor_ops', 0) + floor_ops
    r['bytes'] += nbytes_
    r['ops'] += ops


def phase_trunk_bf16(torch, B16, SK, FO, params, x, results):
    """Walk the parity trunk with identity,down,stem: each kernel gets the
    plain trunk's activation at its position; kernel, plain version and
    the plain cuDNN chain (bf16 biases, the JAX default route) timed."""
    c1 = FO.siamese_conv1(params['conv1'])
    b32 = c1['b'].float()
    x = x.contiguous()
    want = SK.fused_stem_plain(x, c1['w'], b32)
    kern = lambda: SK.fused_stem(x, c1['w'], b32, wk=c1['wk'])
    err = bf16_diff(torch, f'{STEM} bf16 {tuple(x.shape)}->'
                    f'{tuple(want.shape)}', kern(), want)
    add_row(results, STEM, err, cuda_ms(torch, kern),
            cuda_ms(torch, lambda: SK.fused_stem_plain(x, c1['w'], b32),
                    reps=2),
            cuda_ms(torch, lambda: FO._plain_stem(c1, x), reps=2),
            nbytes(x, want, c1['w'], b32), stem_ops(x, c1['w']))
    h = FO.directions_to_batch(want)
    for li in range(4):
        for bi, bp in enumerate(params[f'layer{li + 1}']):
            stride = 2 if (li > 0 and bi == 0) else 1
            if bp['conv1']['w'].shape[2] > FO.IDEN_CIN_CAP:
                h = FO._plain_block(bp, h, stride)      # no kernel here
                continue
            args = FO._kernel_args(bp)
            if 'down' in bp:
                name = DOWN16
                kern = lambda h, a=args, s=stride: B16.fused_bottleneck_down(
                    h, *a, stride=s)
                plain = lambda h, a=args, s=stride: (
                    B16.fused_bottleneck_down_plain(h, *a, stride=s))
            else:
                name = IDEN16
                kern = lambda h, a=args: B16.fused_bottleneck(h, *a)
                plain = lambda h, a=args: B16.fused_bottleneck_plain(h, *a)
            if name == IDEN16 and bi == 1:
                bf16_stage_rows(torch, B16, FO, params[f'layer{li + 1}'][1:],
                                h, results)
            want = plain(h)
            err = bf16_diff(torch, f'{name} {tuple(h.shape)}->'
                            f'{tuple(want.shape)}', kern(h), want)
            macs, _ = block_macs(tuple(h.shape), bp, stride)
            chain = cuda_ms(torch, lambda: FO._plain_block(bp, h, stride),
                            reps=2)
            conv = conv_only_ms(torch, tuple(h.shape), [(bp, stride)])
            add_row(results, name, err, cuda_ms(torch, lambda: kern(h)),
                    cuda_ms(torch, lambda: plain(h), reps=2), chain,
                    nbytes(h, want, *args), 2 * macs, conv_only=conv)
            if name == IDEN16:
                err = bf16_diff(torch, f'{HWNC16} {tuple(h.shape)}',
                                B16.fused_bottleneck_hwnc(h, *args), want)
                add_row(results, HWNC16, err,
                        cuda_ms(torch, lambda: B16.fused_bottleneck_hwnc(
                            h, *args)),
                        cuda_ms(torch, lambda: B16.fused_bottleneck_hwnc_plain(
                            h, *args), reps=2), chain,
                        nbytes(h, want, *args), 2 * macs, conv_only=conv)
            h = want


def bf16_stage_rows(torch, B16, FO, run, h, results):
    """The stage kernels (11, 12) on a layer's identity run of K blocks
    at the plain trunk's activation h: against the plain stage within
    1e-2 of max |plain|, timed beside the cuDNN chain of the same K
    blocks. The share beyond one ulp may grow with K, by 10% per block:
    a moved rounding is read again by the next block's residual, 1x1s
    and 3x3, so on random weights the share grows along the run (4.3%
    after layer2's three blocks; each block alone holds the 1% bar in
    the fused_bottleneck rows on the same activations). Bytes: one read
    of h and one write of the output, plus the weights."""
    blocks = [FO._kernel_args(bp) for bp in run]
    want = B16.fused_bottleneck_stage_plain(h, blocks)
    macs = sum(block_macs(tuple(h.shape), bp, 1)[0] for bp in run)
    weights = [t for blk in blocks for t in blk]

    def chain():
        o = h
        for bp in run:
            o = FO._plain_block(bp, o, 1)
        return o
    chain_ms = cuda_ms(torch, chain, reps=2)
    conv = conv_only_ms(torch, tuple(h.shape), [(bp, 1) for bp in run])
    for name, fn in ((STAGE16, B16.fused_bottleneck_stage),
                     (SSTAGE16, B16.fused_bottleneck_stage_stream)):
        err = bf16_diff(torch, f'{name} K={len(run)} {tuple(h.shape)}',
                        fn(h, blocks), want, share=0.1 * len(run))
        add_row(results, name, err, cuda_ms(torch, lambda: fn(h, blocks)),
                cuda_ms(torch, lambda: B16.fused_bottleneck_stage_plain(
                    h, blocks), reps=2), chain_ms,
                nbytes(h, want, *weights), 2 * macs, conv_only=conv)


def f32_diff(torch, what, got, want, bar):
    """diff() plus the f32 bar: max |kernel - plain| <= bar * max |plain|
    (2e-5 a block, per chained block; 1e-5 the stem), over 5% of the
    outputs nonzero."""
    err, _ = diff(torch, what, got, want)
    scale = float(want.abs().max())
    print(f'  max |plain| {scale}: {err / scale:.3e} of it (bar {bar:g})')
    check(err <= bar * scale, f'{what}: within {bar:g} of max |plain|')
    live = float((want != 0).float().mean())
    check(live > 0.05, f'{what}: {live:.3f} of outputs nonzero')
    return err


def phase_trunk_f32(torch, B16, SK, FO, params, x, results):
    """The f32 modes of kernels 10-15 on the f32 parity trunk (the folded
    f32 model, both directions: the double-width stem on the f32 prep x,
    then 360 images), walked as phase_trunk_bf16 walks the bf16 one:
    each kernel on the plain trunk's activation at its position, against
    its plain version on the card (TF32 off), beside the cuDNN f32 chain
    of the JAX default route; operations at the f32 peak."""
    c1 = FO.siamese_conv1(params['conv1'])
    x = x.contiguous()
    want = SK.fused_stem_plain(x, c1['w'], c1['b'])
    kern = lambda: SK.fused_stem(x, c1['w'], c1['b'], wk=c1['wk'])
    err = f32_diff(torch, f'{STEM32} {tuple(x.shape)}->{tuple(want.shape)}',
                   kern(), want, 1e-5)
    add_row(results, STEM32, err, cuda_ms(torch, kern),
            cuda_ms(torch, lambda: SK.fused_stem_plain(x, c1['w'], c1['b']),
                    reps=2),
            cuda_ms(torch, lambda: FO._plain_stem(c1, x), reps=2),
            nbytes(x, want, c1['w'], c1['b']), stem_ops(x, c1['w']),
            rate=H100_F32_PER_S, tf32_ops=3 * stem_ops(x, c1['w']),
            floor_ops=f32_stem_floor_ops(SK, x, c1['w']))
    h = FO.directions_to_batch(want)
    for li in range(4):
        for bi, bp in enumerate(params[f'layer{li + 1}']):
            stride = 2 if (li > 0 and bi == 0) else 1
            if bp['conv1']['w'].shape[2] > FO.IDEN_CIN_CAP:
                h = FO._plain_block(bp, h, stride)      # no kernel here
                continue
            args, wk = FO._kernel_args(bp), bp['wk']
            if 'down' in bp:
                name = DOWN32
                kern = lambda h, a=args, s=stride, wk=wk: (
                    B16.fused_bottleneck_down(h, *a, stride=s, wk=wk))
                plain = lambda h, a=args, s=stride: (
                    B16.fused_bottleneck_down_plain(h, *a, stride=s))
            else:
                name = IDEN32
                kern = lambda h, a=args, wk=wk: B16.fused_bottleneck(h, *a,
                                                                     wk=wk)
                plain = lambda h, a=args: B16.fused_bottleneck_plain(h, *a)
            if name == IDEN32 and bi == 1:
                f32_stage_rows(torch, B16, FO, params[f'layer{li + 1}'][1:],
                               h, results)
            want = plain(h)
            err = f32_diff(torch, f'{name} {tuple(h.shape)}->'
                           f'{tuple(want.shape)}', kern(h), want, 2e-5)
            macs, _ = block_macs(tuple(h.shape), bp, stride)
            chain = cuda_ms(torch, lambda: FO._plain_block(bp, h, stride),
                            reps=2)
            tops = tf32x3_ops(tuple(h.shape), [(bp, stride)], [False])
            add_row(results, name, err, cuda_ms(torch, lambda: kern(h)),
                    cuda_ms(torch, lambda: plain(h), reps=2), chain,
                    nbytes(h, want, *args), 2 * macs, rate=H100_F32_PER_S,
                    tf32_ops=tops)
            if name == IDEN32:
                err = f32_diff(torch, f'{HWNC32} {tuple(h.shape)}',
                               B16.fused_bottleneck_hwnc(h, *args, wk=wk),
                               want, 2e-5)
                add_row(results, HWNC32, err,
                        cuda_ms(torch, lambda: B16.fused_bottleneck_hwnc(
                            h, *args, wk=wk)),
                        cuda_ms(torch, lambda: B16.fused_bottleneck_hwnc_plain(
                            h, *args), reps=2), chain,
                        nbytes(h, want, *args), 2 * macs, rate=H100_F32_PER_S,
                        tf32_ops=tops)
            h = want


def f32_stage_rows(torch, B16, FO, run, h, results):
    """The f32 stage kernels (11, 12) on a layer's identity run of K
    blocks at the plain f32 trunk's activation h, within 2e-5 of max
    |plain| per chained block, beside the cuDNN f32 chain of the same K
    blocks."""
    blocks = [FO._kernel_args(bp) for bp in run]
    wks = [bp['wk'] for bp in run]
    want = B16.fused_bottleneck_stage_plain(h, blocks)
    macs = sum(block_macs(tuple(h.shape), bp, 1)[0] for bp in run)
    weights = [t for blk in blocks for t in blk]

    def chain():
        o = h
        for bp in run:
            o = FO._plain_block(bp, o, 1)
        return o
    chain_ms = cuda_ms(torch, chain, reps=2)
    for name, fn in ((STAGE32, B16.fused_bottleneck_stage),
                     (SSTAGE32, B16.fused_bottleneck_stage_stream)):
        err = f32_diff(torch, f'{name} K={len(run)} {tuple(h.shape)}',
                       fn(h, blocks, wk=wks), want, 2e-5 * len(run))
        add_row(results, name, err,
                cuda_ms(torch, lambda: fn(h, blocks, wk=wks)),
                cuda_ms(torch, lambda: B16.fused_bottleneck_stage_plain(
                    h, blocks), reps=2), chain_ms,
                nbytes(h, want, *weights), 2 * macs, rate=H100_F32_PER_S,
                tf32_ops=tf32x3_ops(tuple(h.shape),
                                    [(bp, 1) for bp in run],
                                    [False] * len(run)))


def exact(torch, what, got, want):
    """The int8c bar: kernel equal to its plain version on every value,
    and over 5% of the outputs unclipped (not all 0 or 127)."""
    err, frac = diff(torch, what, got, want)
    check(err == 0 and frac == 0, f'{what}: 0 differing values')
    live = float(((want > 0) & (want < 127)).float().mean())
    check(live > 0.05, f'{what}: {live:.3f} of outputs unclipped')
    return err


def int8_block_calls(IK, Q, qb, stride, hwnc):
    """The int8c kernel wrapper(s) for one block: [(row name, kernel(h))]
    and the plain version (the NHWC rows 16 and 17, or the hwnc-named
    rows 19-21 of the JAX package's 'hwnc' route)."""
    a, wk = Q._int8_args(qb), qb['wk']
    if 'down' not in qb:
        fn = IK.fused_bottleneck_int8_hwnc if hwnc else IK.fused_bottleneck_int8
        return ((I8H if hwnc else I8), lambda h: fn(h, *a, qb['sxr'], wk=wk),
                lambda h: IK.fused_bottleneck_int8_plain(h, *a, qb['sxr']))
    plain = lambda h: IK.fused_bottleneck_down_int8_plain(h, *a,
                                                          stride=stride)
    if not hwnc:
        return D8, lambda h: IK.fused_bottleneck_down_int8(
            h, *a, stride=stride, wk=wk), plain
    if stride == 2:
        return D8H2, lambda h: IK.fused_bottleneck_down_s2_int8_hwnc(
            h, *a, wk=wk), plain
    return D8H1, lambda h: IK.fused_bottleneck_down_int8_hwnc(
        h, *a, wk=wk), plain


def phase_trunk_int8(torch, IK, SK, Q, FO, q, x, results, wide):
    """Walk an int8c model on the prepped batch x: the stem kernel, then
    each block kernel on the plain trunk's activation at its position,
    each equal to its plain version, both timed. wide: the serving-d2
    route (double-width stem, Cout 128, its halves as the batch halves;
    the hwnc-named kernels, rows 18-21); else serving-d1's (the NHWC
    kernels, rows 16-17; the Cout-64 stem is checked and timed but not
    a row: no main path launches it)."""
    x8 = Q.quantize_input(x, q['cfg_scales']['in'])
    c1 = FO.siamese_conv1(q['conv1']) if wide else q['conv1']
    args = (c1['w'], c1['m'], c1['b'])
    want = SK.fused_stem_int8_plain(x8, *args)
    err = exact(torch, f'{STEM8} {tuple(x8.shape)}->{tuple(want.shape)}',
                SK.fused_stem_int8(x8, *args, wk=c1['wk']), want)
    kern = cuda_ms(torch, lambda: SK.fused_stem_int8(x8, *args, wk=c1['wk']))
    plain = cuda_ms(torch, lambda: SK.fused_stem_int8_plain(x8, *args),
                    reps=2)
    if wide:
        add_row(results, STEM8, err, kern, plain, None,
                nbytes(x8, want, *args), stem_ops(x8, c1['w']),
                rate=H100_INT8_PER_S)
    else:
        print(f'  {STEM8} Cout 64: {kern:.4f} ms, plain {plain:.4f} ms, '
              f'{stem_ops(x8, c1["w"]) / kern / 1e9:.2f} TOP/s at K = 245')
    h = FO.directions_to_batch(want) if wide else want
    for li in range(4):
        for bi, qb in enumerate(q[f'layer{li + 1}']):
            stride = 2 if (li > 0 and bi == 0) else 1
            name, kern, plain = int8_block_calls(IK, Q, qb, stride, wide)
            want = plain(h)
            err = exact(torch, f'{name} {tuple(h.shape)}->'
                        f'{tuple(want.shape)}', kern(h), want)
            macs, _ = block_macs(tuple(h.shape), qb, stride)
            weights = [t for c in ('conv1', 'conv2', 'conv3', 'down')
                       if c in qb for t in qb[c].values()]
            add_row(results, name, err, cuda_ms(torch, lambda: kern(h)),
                    cuda_ms(torch, lambda: plain(h), reps=1), None,
                    nbytes(h, want, *weights), 2 * macs,
                    rate=H100_INT8_PER_S)
            h = want


def v2_row(torch, results, name, kern, plain, h, blocks, bar=1,
           share=0.01, f32=False):
    """One v2 kernel call on the plain trunk's activation h against its
    plain version: within `bar` LSB (one per block chained in the call)
    on under `share` of the values (None: any share); both timed, the
    row's bytes and operations added (f32: the row of the kernel's f32
    mode, operations at the f32 peak, no bf16 conv_only yardstick).
    blocks: [(block params, stride)] the call covers. Returns the plain
    output."""
    name = V2F32[name] if f32 else name
    want = plain(h)
    err, frac = diff(torch, f'{name} {tuple(h.shape)}->'
                     f'{tuple(want.shape)} {str(want.dtype)[6:]}',
                     kern(h), want)
    check(err <= bar and (share is None or frac < share),
          f'{name}: <={bar} LSB on <{share} of values')
    live = float(((want > 0) & (want < 127)).float().mean())
    check(live > 0.05, f'{name}: {live:.3f} of outputs unclipped')
    macs, shape = 0, tuple(h.shape)
    for blk, stride in blocks:
        m, shape = block_macs(shape, blk, stride)
        macs += m
    weights = [t for blk, _ in blocks
               for c in ('conv1', 'conv2', 'conv3', 'down') if c in blk
               for t in blk[c].values()]
    add_row(results, name, err, cuda_ms(torch, lambda: kern(h)),
            cuda_ms(torch, lambda: plain(h), reps=2), None,
            nbytes(h, want, *weights), 2 * macs,
            rate=H100_F32_PER_S if f32 else H100_BF16_PER_S,
            conv_only=None if f32 else conv_only_ms(torch, tuple(h.shape),
                                                    blocks),
            tf32_ops=tf32x3_ops(tuple(h.shape), blocks,
                                [h.dtype == torch.int8]
                                + [True] * (len(blocks) - 1)) if f32
            else None)
    return want


def phase_trunk(torch, BK, Q, FO, q, x, results, f32=False):
    """Walk the trunk: each kernel gets the plain trunk's activation at
    its position; outputs compared, both versions timed. f32: the model
    quantized at compute_dtype=f32, its calls reported under the V2F32
    rows (int8 between calls, f32 holding the integers where a call
    hands the next kernel its output, as in the forward)."""
    h = Q._stem_v2(q, x)
    for name, kern, plain, blocks in trunk_calls(q, BK, FO):
        bar = (check_stage_blocks(torch, BK, FO, q['layer1'], h)
               if name == STAGE else 1)
        h = v2_row(torch, results, name, kern, plain, h, blocks, bar,
                   f32=f32)


def phase_trunk_v2_variants(torch, BK, Q, FO, q, x, results, f32=False):
    """The other v2 feature sets' kernels on the plain trunk's
    activations: at layer1's input the hwncp stage (kernel 6) and the
    stride-1 projections (7, 9); at each layer's identity run the
    down=False stage (kernel 2's second mode); each identity block with
    conv1 Cin <= 512 through kernel 8. Output dtypes as the megasteps
    give them. f32: as phase_trunk."""
    h = Q._stem_v2(q, x)
    for li in range(1, 5):
        layer = q[f'layer{li}']
        a = FO._kernel_args(layer[0])
        run = [FO._kernel_args(b) for b in layer[1:]]
        rs = [b['r'] for b in layer[1:]]
        wks = [b.get('wk') for b in layer]
        if li == 1:
            v2_row(torch, results, HWNCP,
                   lambda h: BK.fused_bottleneck_i8v2_hwncp_stage(
                       h, a, run, rs, wk=wks),
                   lambda h: BK.fused_bottleneck_i8v2_hwncp_stage_plain(
                       h, a, run, rs), h, [(b, 1) for b in layer],
                   bar=len(layer), f32=f32)
            v2_row(torch, results, DOWN1N,
                   lambda h: BK.fused_bottleneck_down_i8v2(
                       h, *a, out_int8=False, wk=wks[0]),
                   lambda h: BK.fused_bottleneck_down_i8v2_plain(
                       h, *a, out_int8=False), h, [(layer[0], 1)], f32=f32)
            h = v2_row(torch, results, DOWN1H,
                       lambda h: BK.fused_bottleneck_down_i8v2_hwnc(
                           h, *a, wk=wks[0]),
                       lambda h: BK.fused_bottleneck_down_i8v2_hwnc_plain(
                           h, *a), h, [(layer[0], 1)], f32=f32)
        else:
            h = BK.fused_bottleneck_i8v2_down_s2_plain(h, *a)
        # an identity run of k blocks: each block within the one-block
        # bar on the plain run's input, the run within k LSB. The share
        # of differing values is not bounded: a flipped value is read
        # again by the next block's residual, 1x1s and 3x3, so on random
        # weights the share grows along the run (18.5% after layer3's
        # five blocks, each alone at ~2e-4)
        k = check_stage_blocks(torch, BK, FO, layer[1:], h)
        o = li in (1, 4)        # int8 out at layer1 and the trunk's end
        want = v2_row(torch, results, RUN,
                      lambda h: BK.fused_bottleneck_i8v2_stage(
                          h, None, run, rs, out_int8=o, wk=wks[1:]),
                      lambda h: BK.fused_bottleneck_i8v2_stage_plain(
                          h, None, run, rs, out_int8=o),
                      h, [(b, 1) for b in layer[1:]], bar=k, share=None,
                      f32=f32)
        if layer[1]['conv1']['w'].shape[2] > FO.IDEN_CIN_CAP:
            h = want.to(torch.int8)
            continue
        for k, (blk, r) in enumerate(zip(run, rs)):
            o = k == len(run) - 1   # int8 before the plain stride-2 block
            h = v2_row(torch, results, IDENN,
                       lambda h, blk=blk, r=r, o=o, wk=wks[k + 1]:
                       BK.fused_bottleneck_i8v2(h, *blk, r, out_int8=o,
                                                wk=wk),
                       lambda h, blk=blk, r=r, o=o:
                       BK.fused_bottleneck_i8v2_plain(h, *blk, r, out_int8=o),
                       h, [(layer[k + 1], 1)], f32=f32)


def megastep_cpu(path):
    """Reference job of phase 3: fn(*args, **kwargs) of the (fn, args,
    kwargs) that file `path` (RefPool.put) holds, the plain path on the
    CPU. numpy."""
    import torch
    fn, args, kwargs = torch.load(path, weights_only=False)
    with torch.no_grad():
        return host_tree(fn(*args, **kwargs))


def phase_megastep(torch, name, step, reference, wrappers, expected,
                   n_pairs, card, directions, margins, pool, bar=0.02,
                   iters=10):
    """One megastep with the counts set to 0 just before it: launch
    counts, timing, and the first `few` pairs' logits (both directions at
    directions=2) against the plain path on the CPU (reference(n) gives
    its (fn, args, kwargs) for the first n pairs; it runs in `pool`, the
    comparison when the pool finishes), within `bar` of max |logit| (2%
    for the bf16 and quantized paths, F32_LOGIT_BAR at f32); the error
    over the first m pairs, for each m in `margins`, is printed beside
    the bar (it shows how much room the bar leaves). Returns the launch
    counts and the logits."""
    print(f'--- megastep {name}')
    for w in wrappers.values():
        w.launches = 0
    logits, ij, ji = step()
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    print('launches per megastep:', launches)
    want = {n: expected.get(n, 0) for n in wrappers}
    check(launches == want, f'{name}: launch counts {launches}, '
          f'expected {want}')
    outs = logits if directions == 2 else (logits,)
    check(all(tuple(o.shape) == (n_pairs, 2)
              and bool(torch.isfinite(o).all()) for o in outs),
          'finite (P, 2) logits')

    with quiet():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    print(f'megastep {name}: {n_pairs} pairs, {dt / iters * 1e3:.3f} '
          f'ms/step, {n_pairs * iters / dt:.1f} pairs/s ({card})')

    few = 4
    n_ref = max([few, *margins])
    with torch.no_grad():
        job = pool.put(torch, reference(n_ref))
    outs = [o[:n_ref].cpu() for o in outs]
    decisions = ij[:few].cpu(), ji[:few].cpu()

    def rel_err(got, r):
        scale = max(float(r.abs().max()), 1e-6)
        return float((got - r).abs().max()) / scale, scale

    def then(ref):
        ref = torch_tree(torch, ref)
        refs = ref if directions == 2 else (ref,)
        print(f'--- megastep {name}: logits against the plain CPU path on '
              f'{n_ref} pairs')
        for d, (o, r_all) in enumerate(zip(outs, refs)):
            got, r = o[:few], r_all[:few]
            rel, scale = rel_err(got, r)
            print(f'direction {d}: logits vs plain CPU path ({few} pairs): '
                  f'max rel err {rel:.3e}')
            for m in margins:
                print(f'  over {m} pairs: max rel err '
                      f'{rel_err(o[:m], r_all[:m])[0]:.3e}')
            print('  logits (card):', got.tolist())
            print('  logits (cpu): ', r.tolist())
            check(rel <= bar and scale > 1e-3,
                  f'{name}: nonzero logits within {bar:g} of max |logit|')
        refs = tuple(r[:few] for r in refs)
        s = [torch.sigmoid(r) for r in refs]
        p_ij, p_ji = ((s[0][:, 1] + s[1][:, 0]) / 2,
                      (s[0][:, 0] + s[1][:, 1]) / 2) \
            if directions == 2 else (s[0][:, 1], s[0][:, 0])
        for p, dec in zip((p_ij, p_ji), decisions):
            sure = (p - 0.5).abs() > 1e-2
            check(bool((dec[sure] == (p[sure] > 0.5)).all()),
                  f'{name}: decisions agree where the reference is sure')
    pool.later(f'megastep plain CPU path: {name}', megastep_cpu, job,
               then=then)
    return launches, logits


# the predictor phase: instance counts of its four scenes (pair buckets
# 8, 32, 64, 128), the ones whose matrices are also computed on the CPU
# (the smallest; the two smallest for the depth-only head, whose bf16 and
# v2 routes compare only the pairs far from a tie, and whose head is
# centred on the second), the head gain (at the kaiming init the 2-logit
# head gives |logits| ~ 1e-2, every probability within 1e-2 of 0.5, so no
# decision would be sure) and the timing repeats (median of 5 after a
# warm-up)
PRED_INSTANCES = (3, 7, 10, 16)
PRED_CPU_SCENES = 1
DEPTH_CPU_SCENES = 2
# the model kernels of the f32 predictor's identity,down,stem route
F32_MODEL = {IDEN16: 5, DOWN16: 3, STEM: 1}
HEAD_GAIN = 100.0
# the centred depth-only head's logit bars on the bf16 and v2 routes, held
# on every pair, relative to max |logit| + the part the centring took off
# (compare_on_cpu); measured over all pairs of the two smallest scenes:
# bf16 1.43e-3, v2 8.80e-3 (H100 80GB HBM3, 700 W)
DEPTH_BARS = {'bf16': 2.5e-3, 'v2': 1.2e-2}
PRED_REPS = 5


PRED_CLASSES = {'InstaOrderNet_o': 2, 'InstaOrderNet_od': [2, 3],
                'InstaOrderNet_d': 3}


def predictor_nets(torch, resnet, dev, methods=tuple(PRED_CLASSES)):
    """Full ResNet-50 width, 5-channel stem, from seed 0 (kaiming), for
    each of `methods`: the 2-logit InstaOrderNet_o net, a dual-head (2,
    3) InstaOrderNet_od net and a 3-class InstaOrderNet_d net, their
    heads scaled by HEAD_GAIN."""
    nets = {}
    for method in methods:
        classes = PRED_CLASSES[method]
        gen = torch.Generator().manual_seed(0)
        params, stats, cfg = resnet.init(
            gen, arch='resnet50', in_channels=5, num_classes=classes,
            weight_init='kaiming_out', device=dev)
        for fc in ('fc', 'fc_occ', 'fc_depth'):
            if fc in params:
                params[fc] = {k: v * HEAD_GAIN for k, v in params[fc].items()}
        nets[method] = (params, stats, cfg)
    return nets


def centre_depth_head(torch, TPL, net, scene, dev):
    """(the 3-class net with its head centred and scaled (centre_heads'
    rule, on tensors) on the logits of `scene`'s pairs, both directions,
    from the plain f32 predictor (no kernel), the largest common part
    the centring took off a logit). At HEAD_GAIN its logits are in the
    thousands and share one class across every pair and both swap
    directions: decode_depth's swap average then sits on 0.5 / 0.5 for
    every pair, and no decision is sure. The centred logits are the
    small difference of the trunk's terms and that common part, so
    compare_on_cpu holds their rounding on the logits' scale before the
    centring (max |logit| + the common part)."""
    import numpy as np
    params, stats, cfg = net
    pred = TPL.make_folded_predictor(params, stats, cfg, 'InstaOrderNet_d',
                                     input_size=OUT, device=dev)
    with torch.no_grad():
        _, valid, o1, o2, _ = pred.pair_outputs(*scene)
    valid = valid.cpu().numpy()
    z = np.concatenate([o.double().cpu().numpy()[valid] for o in (o1, o2)])
    mu = z.mean(axis=0)
    g = LOGIT_SPREAD / max(float((z - mu).std()), 1e-30)
    w, b = params['fc']['w'], params['fc']['b']
    shift = g * float(np.abs(mu).max())
    mu = torch.as_tensor(mu, dtype=b.dtype, device=b.device)
    return (dict(params, fc={'w': w * g, 'b': (b - mu) * g}), stats,
            cfg), shift


def pred_scenes(serving):
    """One synthetic 480x640 scene per instance count (numpy)."""
    out = []
    for n in PRED_INSTANCES:
        images, masks, bboxes = serving.synthetic_scenes(
            1, HEIGHT, WIDTH, n, seed=n)
        out.append((images[0], masks[0], bboxes[0]))
    return out


def pred_launches(torch, wrappers, fn):
    """Run fn() with every launch count set to 0 just before; returns
    (fn's result, the nonzero counts)."""
    for w in wrappers.values():
        w.launches = 0
    res = fn()
    torch.cuda.synchronize()
    return res, {n: w.launches for n, w in wrappers.items() if w.launches}


def sure_matrix_check(name, got, want, p_ij, p_ji, pidx, valid, exact):
    """Matrices equal (exact), or equal at the cells whose reference
    probability is more than 1e-2 from 0.5."""
    if exact:
        check((got == want).all(), f'{name}: matrices equal')
        return int(got.size)
    n = 0
    for k in range(len(pidx)):
        if not valid[k]:
            continue
        i, j = (int(v) for v in pidx[k])
        for (a, b), p in (((i, j), p_ij[k]), ((j, i), p_ji[k])):
            if abs(float(p) - 0.5) > 1e-2:
                check(got[a, b] == want[a, b],
                      f'{name}: sure cell ({a}, {b}) equal')
                n += 1
    check(n > 0, f'{name}: some decision is sure')
    return n


def depth_probs(torch, o1, o2):
    """decode_depth's averaged softmax [closer, farther, equal] of the
    (i, j) direction, float64."""
    d1 = torch.softmax(o1.double(), -1)
    if o2 is None:
        return d1
    d2 = torch.softmax(o2.double(), -1)
    return torch.stack([(d1[:, 0] + d2[:, 1]) / 2, (d1[:, 1] + d2[:, 0]) / 2,
                        (d1[:, 2] + d2[:, 2]) / 2], 1)


def sure_depth_check(name, got, want, pw, pidx, valid, exact, margin):
    """Depth matrices equal (exact), or equal at the pairs whose averaged
    CPU softmax pw (depth_probs) puts log(top / next) above `margin`,
    one margin for every pair (compare_on_cpu's 4 x the route's verified
    logit error). Returns the cells compared."""
    import torch
    if exact:
        check((got == want).all(), f'{name}: depth matrices equal')
        return int(got.size)
    top = torch.sort(pw, -1).values
    lead = torch.log(top[:, -1]) - torch.log(top[:, -2])
    n = 0
    for k in range(len(pidx)):
        if valid[k] and float(lead[k]) > margin:
            i, j = (int(v) for v in pidx[k])
            check(got[i, j] == want[i, j] and got[j, i] == want[j, i],
                  f'{name}: sure depth cells ({i}, {j}) equal')
            n += 2
    return n


def pair_results(pred, scenes, depth, dual):
    """The side of compare_on_cpu that `pred` gives, on each scene:
    (pair outputs (pidx, valid, out1, out2, n), its matrices
    (infer_depth_order for the depth-only head, else infer_occ_order),
    infer_occ_depth_order's for a dual head, else None). numpy."""
    out = []
    for scene in scenes:
        o = pred.pair_outputs(*scene)
        # the infer_* calls decode this one forward's outputs
        pred.pair_outputs = lambda *a, **kw: o
        try:
            mats = (pred.infer_depth_order(*scene) if depth else
                    pred.infer_occ_order(*scene))
            od = pred.infer_occ_depth_order(*scene) if dual else None
        finally:
            del pred.pair_outputs
        out.append(host_tree((o, mats, od)))
    return out


def predictor_cpu(path, scenes, depth, dual):
    """Reference job of phase 4: pair_results of the predictor that file
    `path` holds (RefPool.put of the card's predictor moved to the CPU:
    the plain versions)."""
    import torch
    with torch.no_grad():
        return pair_results(torch.load(path, weights_only=False), scenes,
                            depth, dual)


def compare_on_cpu(torch, name, card, cpu, bar, exact, dual, depth,
                   shift=0.0):
    """The matrices and logits of a predictor on the card against the same
    predictor on the CPU (the plain versions), on one scene: `card` and
    `cpu` its pair_results there. exact routes (f32, int8c)
    hold every pair's logits to `bar`; the bf16 and v2 routes hold the
    first 4 pairs' to `bar` and print all pairs' (the megasteps' rule:
    over many pairs the v2 route spreads ~2e-2 even between JAX's own
    two routes, ROADMAP.md queue 3), and the matrices where the CPU's
    probability is more than 1e-2 from 0.5. shift: a common part taken
    off every logit (centre_depth_head), added to the scale the error is
    held on. The depth-only head holds every pair's logits to `bar` on
    every route; on the bf16 and v2 routes it then compares the depth
    matrices at the pairs whose CPU log(top / next) averaged probability
    exceeds 4 x the largest error that bar allows (a logit error d moves
    the log of each swap-averaged probability by at most 2 d, so those
    decisions cannot flip). Returns the cells compared."""
    (pidx, valid, g1, g2, n), got, got_od = torch_tree(torch, card)
    (_, _, w1, w2, _), want, want_od = torch_tree(torch, cpu)
    flat = lambda o: [] if o is None else (list(o) if isinstance(o, tuple)
                                           else [o])
    few = len(pidx) if exact or depth else 4
    worst = worst_few = top_scale = 0.0
    for g, w in zip(flat(g1) + flat(g2), flat(w1) + flat(w2)):
        scale = max(float(w.abs().max()) + shift, 1e-6)
        top_scale = max(top_scale, scale)
        d = (g - w).abs()
        worst = max(worst, float(d.max()) / scale)
        worst_few = max(worst_few, float(d[:few].max()) / scale)
    check(worst_few <= bar, f'{name}: logits of {few} pairs within {bar} '
          f'of max |logit| (+ {shift:.4g}) of the CPU ({worst_few:.3e})')
    if depth:
        margin = 4 * bar * top_scale
        cells = sure_depth_check(
            name, got.numpy(), want.numpy(), depth_probs(torch, w1, w2),
            pidx.numpy(), valid.numpy(), exact, margin)
        print(f'  {name} N={n}: card vs CPU logits max rel err '
              f'{worst_few:.3e} over {few} pairs, {worst:.3e} over all '
              f'{len(pidx)}; {cells} depth matrix cells compared'
              + ('' if exact else f' (log(top / next) above {margin:.4g})'))
        return cells
    o1 = w1[0] if dual else w1
    o2 = None if w2 is None else (w2[0] if dual else w2)
    s1 = torch.sigmoid(o1)
    if o2 is None:
        p_ij, p_ji = s1[:, 1], s1[:, 0]
    else:
        s2 = torch.sigmoid(o2)
        p_ij, p_ji = (s1[:, 1] + s2[:, 0]) / 2, (s1[:, 0] + s2[:, 1]) / 2
    cells = sure_matrix_check(name, got.numpy(), want.numpy(), p_ij, p_ji,
                              pidx.numpy(), valid.numpy(), exact)
    if dual and exact:
        for g, w in zip(got_od, want_od):
            check((g == w).all(), f'{name}: occ/depth matrices equal')
    print(f'  {name} N={n}: card vs CPU logits max rel err {worst_few:.3e} '
          f'over {few} pairs, {worst:.3e} over all {len(pidx)}; {cells} '
          f'matrix cells compared')
    return cells


def defer_predictor_check(torch, pool, name, pred, scenes, bar, exact,
                          shift=0.0):
    """compare_on_cpu of `pred` on each of `scenes`: the card's side now,
    the CPU's in the pool (predictor_cpu), the comparisons when the pool
    finishes (for the depth-only head with at least one depth decision
    sure over the scenes). A dual head's infer_depth_order is checked to
    be its infer_occ_depth_order's depth now."""
    depth = pred.method == 'InstaOrderNet_d'
    dual = pred.method == 'InstaOrderNet_od'
    with torch.no_grad():
        card = pair_results(pred, scenes, depth, dual)
        if dual:
            for scene, (_, _, od) in zip(scenes, card):
                check((pred.infer_depth_order(*scene) == od[1]).all(),
                      f'{name}: infer_depth_order is the dual call\'s '
                      f'depth')

    def then(cpu):
        cells = [compare_on_cpu(torch, name, c, w, bar, exact, dual, depth,
                                shift) for c, w in zip(card, cpu)]
        check(not depth or sum(cells) > 0, f'{name}: some depth decision '
              f'is sure on the {len(scenes)} scenes')
    pool.later(f'predictor CPU runs: {name}', predictor_cpu,
               pool.put(torch, pred.to('cpu')), scenes, depth, dual,
               then=then)


def phase_predictors(torch, serving, resnet, TPL, wrappers, calib_x, dev,
                     card, pool):
    """Phase 4; its card-vs-CPU comparisons deferred to `pool`'s finish
    (defer_predictor_check). Returns {row name: launches} for rows
    counted here."""
    nets = predictor_nets(torch, resnet, dev)
    scenes = pred_scenes(serving)
    nets['InstaOrderNet_d'], depth_shift = centre_depth_head(
        torch, TPL, nets['InstaOrderNet_d'], scenes[1], dev)
    b16 = torch.bfloat16
    kw = dict(patch_or_image='patch', input_size=OUT, prep_impl='pallas5',
              device=dev)
    t0 = time.perf_counter()
    preds = [
        ('v2 d2', 'InstaOrderNet_od', lambda n: TPL.make_v2_predictor(
            *n, 'InstaOrderNet_od', [calib_x], prep_dtype=b16,
            prep_passes=1, **kw), 0.02, False,
         {PREP: 1, STAGE: 1, DOWN: 3, IDEN: 10}),
        ('v2 d1', 'InstaOrderNet_od', lambda n: TPL.make_v2_predictor(
            *n, 'InstaOrderNet_od', [calib_x], prep_dtype=b16,
            prep_passes=1, directions=1, **kw), 0.02, False,
         {PREP: 1, STAGE: 1, DOWN: 3, IDEN: 10}),
        # the v2 model at compute_dtype=f32 (the f32 modes of rows 2-4,
        # its f32 pair batch through row 1'')
        ('v2-f32 d2', 'InstaOrderNet_od', lambda n: TPL.make_v2_predictor(
            *n, 'InstaOrderNet_od', [calib_x], compute_dtype=torch.float32,
            **kw), 0.02, False, {PREP: 1, STAGE: 1, DOWN: 3, IDEN: 10}),
        ('int8c d2', 'InstaOrderNet_o', lambda n: TPL.make_int8_predictor(
            *n, 'InstaOrderNet_o', [calib_x], prep_dtype=b16, **kw), 1e-5,
         True, {PREP: 1, I8: 12, D8: 4}),
        ('bf16 d2 identity,down,stem', 'InstaOrderNet_o',
         lambda n: TPL.make_folded_predictor(
             *n, 'InstaOrderNet_o', dtype=b16, use_pallas=KFEATS,
             prep_dtype=b16, **kw), 0.02, False,
         {PREP: 1, IDEN16: 5, DOWN16: 3, STEM: 1}),
        ('f32 d2', 'InstaOrderNet_o', lambda n: TPL.make_folded_predictor(
            *n, 'InstaOrderNet_o', use_pallas=KFEATS, **kw), 1e-5, True,
         {PREP: 1, **F32_MODEL}),
        # the cuDNN f32 route (no model kernel; PR 8's f32 predictor),
        # timed beside the kernels in the same call; its card-vs-CPU
        # check is the kernel predictor's (bar None: not repeated)
        ('f32 d2 cuDNN', 'InstaOrderNet_o',
         lambda n: TPL.make_folded_predictor(*n, 'InstaOrderNet_o', **kw),
         None, True, {PREP: 1}),
        # the depth-only head (3 classes) through the four factories,
        # infer_depth_order (decode_depth averages the swapped direction
        # with its labels exchanged)
        ('d f32 d2', 'InstaOrderNet_d', lambda n: TPL.make_folded_predictor(
            *n, 'InstaOrderNet_d', use_pallas=KFEATS, **kw), 1e-5, True,
         {PREP: 1, **F32_MODEL}),
        ('d bf16 d2 identity,down,stem', 'InstaOrderNet_d',
         lambda n: TPL.make_folded_predictor(
             *n, 'InstaOrderNet_d', dtype=b16, use_pallas=KFEATS,
             prep_dtype=b16, **kw), DEPTH_BARS['bf16'], False,
         {PREP: 1, IDEN16: 5, DOWN16: 3, STEM: 1}),
        ('d int8c d2', 'InstaOrderNet_d', lambda n: TPL.make_int8_predictor(
            *n, 'InstaOrderNet_d', [calib_x], prep_dtype=b16, **kw), 1e-5,
         True, {PREP: 1, I8: 12, D8: 4}),
        ('d v2 d2', 'InstaOrderNet_d', lambda n: TPL.make_v2_predictor(
            *n, 'InstaOrderNet_d', [calib_x], prep_dtype=b16,
            prep_passes=1, **kw), DEPTH_BARS['v2'], False,
         {PREP: 1, STAGE: 1, DOWN: 3, IDEN: 10}),
        # the dual head on the bf16 stage / sstage / hwnc sets and on
        # int8c hwnc,down,stem
        *((f'od bf16 d2 {f}', 'InstaOrderNet_od',
           (lambda f: lambda n: TPL.make_folded_predictor(
               *n, 'InstaOrderNet_od', dtype=b16, use_pallas=(f,),
               prep_dtype=b16, **kw))(f), 0.02, False, {PREP: 1, k: c})
          for f, k, c in (('stage', STAGE16, 2), ('sstage', SSTAGE16, 2),
                          ('hwnc', HWNC16, 5))),
        ('od int8c d2 hwnc,down,stem', 'InstaOrderNet_od',
         lambda n: TPL.make_int8_predictor(
             *n, 'InstaOrderNet_od', [calib_x], prep_dtype=b16,
             use_pallas=('hwnc', 'down', 'stem'), **kw), 1e-5, True,
         {PREP: 1, I8H: 12, D8H1: 1, D8H2: 3, STEM8: 1}),
    ]
    timing = {}
    counted = {}
    for name, method, make, bar, exact, expected in preds:
        print(f'--- predictor {name} ({method})')
        pred = make(nets[method])
        dual = method == 'InstaOrderNet_od'
        # the depth-only head has no occlusion decode
        infer = (pred.infer_depth_order if method == 'InstaOrderNet_d'
                 else pred.infer_occ_order)
        for k, scene in enumerate(scenes):
            calls = [(infer.__name__, infer)]
            if dual and pred.directions == 2:
                calls.append(('infer_occ_depth_order',
                              pred.infer_occ_depth_order))
            for cname, fn in calls:
                out, got = pred_launches(torch, wrappers,
                                         lambda: fn(*scene))
                n = PRED_INSTANCES[k]
                print(f'  {cname} N={n}: launches {got}')
                check(got == expected, f'predictor {name} {cname}: launches '
                      f'{got}, expected {expected}')
                mats = out if isinstance(out, tuple) else (out,)
                check(all(m.shape == (n, n) for m in mats),
                      f'predictor {name}: (N, N) matrices')
            if name == 'f32 d2' and k == len(scenes) - 1:
                counted[PREP_F32] = got[PREP]
            ms = []
            with quiet():
                for _ in range(PRED_REPS + 1):
                    t1 = time.perf_counter()
                    infer(*scene)
                    ms.append((time.perf_counter() - t1) * 1e3)
            ms = sorted(ms[1:])[PRED_REPS // 2]
            timing[name, PRED_INSTANCES[k]] = ms
        if bar:
            depth = method == 'InstaOrderNet_d'
            defer_predictor_check(
                torch, pool, f'predictor {name}', pred,
                scenes[:DEPTH_CPU_SCENES if depth else PRED_CPU_SCENES], bar,
                exact, depth_shift if depth else 0.0)
        if name == 'f32 d2':
            for mode in ('image', 'resize', 'orig'):
                other = TPL.OrderPredictor(
                    pred.apply_fn, pred.cfg, pred.params, pred.stats,
                    'InstaOrderNet_o', mode,
                    input_size=None if mode == 'orig' else OUT,
                    siamese_fn=pred.siamese_fn, device=dev)
                _, got = pred_launches(
                    torch, wrappers, lambda: other.infer_occ_order(*scenes[0]))
                print(f'  f32 {mode} mode: launches {got}')
                check(got == F32_MODEL, f'f32 {mode} mode runs the model '
                      f'kernels and no prep kernel: {got}')
                defer_predictor_check(torch, pool, f'predictor f32 {mode}',
                                      other, scenes[:1], 1e-5, True)
        del pred
        torch.cuda.empty_cache()
    print(f'predictor phase: {time.perf_counter() - t0:.1f} s')
    for name, method, *_ in preds:
        row = [timing[name, n] for n in PRED_INSTANCES]
        per = ', '.join(f'N={n} (pairs {n * (n - 1) // 2}): {ms:.3f} ms'
                        for n, ms in zip(PRED_INSTANCES, row))
        call = ('infer_depth_order' if method == 'InstaOrderNet_d'
                else 'infer_occ_order')
        print(f'predictor {name}: {call} per image {per}; '
              f'{len(row) / (sum(row) / 1e3):.2f} images/s over the '
              f'{len(row)} scenes ({card})')
    return counted


def phase_v2_f32_forwards(torch, serving, Q, q32, cfg, x32, counters,
                          n_pairs, card, launches, pool):
    """The v2 model at compute_dtype=f32 through apply_folded_v2 (d1) and
    apply_folded_v2_siamese (d2) on the smoke cell's pair batch x32, per
    feature set of V2F32_FORWARDS, each with the counts set to 0 just
    before: launches, timing, and the logits against the same forward on
    the CPU (2% of max |logit|, as the v2 megasteps). Adds the launches
    to `launches` under the V2F32 rows."""
    from instaorder_tpu_torch.convert import tree_to
    q_cpu = tree_to(q32, 'cpu')
    t0 = time.perf_counter()
    for fname, feats, expected in V2F32_FORWARDS:
        for directions in (1, 2):
            fwd = (Q.apply_folded_v2_siamese if directions == 2
                   else Q.apply_folded_v2)

            def step(fwd=fwd, feats=feats, directions=directions):
                logits = fwd(q32, cfg, x32, use_pallas=feats)
                dec = serving.decode_occ(*logits) if directions == 2 \
                    else serving.decode_occ(logits)
                return (logits, *dec)

            def reference(few, fwd=fwd, feats=feats):
                return fwd, (q_cpu, cfg, x32[:few].cpu()), {
                    'use_pallas': feats}

            got, _ = phase_megastep(
                torch, f'v2 f32 d{directions} +{fname}', step, reference,
                counters, expected, n_pairs, card, directions,
                (MARGIN_PAIRS,), pool, iters=3)
            for k, n in got.items():
                # the stage launches of the hwncs set are kernel 2's
                # down=False mode
                run = feats is not True and 'hwncs' in feats
                row = (V2F32[STEMQ8] if k == STEM else
                       V2F32[RUN] if k == STAGE and run else V2F32.get(k))
                if n and row is not None and row not in launches:
                    launches[row] = n
    print(f'v2 f32 forwards: {time.perf_counter() - t0:.1f} s')


def check_int8c_same_input(torch, Q, FO, q, cfg, x, directions, feats,
                           logits):
    """The int8c kernel route against the plain int8c forward on the same
    prepped card tensor x: the trunk's int8 output equal on every value,
    the megastep's logits within 1e-5 of max |logit| (only the f32 head
    may reassociate)."""
    def trunk(use):
        x8 = Q.quantize_input(x, q['cfg_scales']['in'])
        if directions == 2:
            wide = dict(q, conv1=FO.siamese_conv1(q['conv1']))
            h = FO.directions_to_batch(Q._stem_int8(wide, x8, use_pallas=use))
        else:
            h = Q._stem_int8(q, x8, use_pallas=use)
        return Q._trunk_int8(q, cfg, h, use_pallas=use)

    hk, hp = trunk(feats), trunk(False)
    diff(torch, 'int8c trunk output, kernels vs plain (same input)', hk, hp)
    check(torch.equal(hk, hp), 'int8c trunk output equal to the plain one')
    fwd = Q.apply_folded_int8_siamese if directions == 2 \
        else Q.apply_folded_int8
    want = fwd(q, cfg, x, use_pallas=False)
    for d, (o, w) in enumerate(zip(*((logits, want) if directions == 2
                                     else ((logits,), (want,))))):
        scale = max(float(w.abs().max()), 1e-6)
        rel = float((o - w).abs().max()) / scale
        print(f'direction {d}: logits vs the plain int8c forward on the card '
              f'(same input, all pairs): max rel err {rel:.3e}')
        check(rel <= 1e-5, 'int8c logits within 1e-5 of the plain forward')


# ---- the Tester (eval/tester.py) --------------------------------------------
# The InstaOrder fixture at the serving scene size: 8 images of 480x640,
# 6 instances each (15 pairs an image); COCOA and KINS at their defaults
TESTER_IMAGES = 8
TESTER_INSTANCES = 6
# the Tester images whose records and metrics the CPU's are held against
TESTER_CPU_IMAGES = 2
# a decision is sure when its reference probability (sigmoid at 0.5) or
# its argmax (top probability over the runner-up) is more than this away
# from flipping; the predictor phase's rule
SURE_MARGIN = 1e-2
# the standard deviation of the Tester nets' centred logits (centre_heads)
LOGIT_SPREAD = 4.0
# the images whose pairs centre the heads
CENTRE_IMAGES = 2
# what the Tester reads of the experiment YAMLs, written out because
# PyYAML may be missing where this runs; tests/test_torch_tester_host.py
# holds each value against cli/config.load_config of the file
_O = {'algo': 'InstaOrderNet_o', 'backbone_arch': 'resnet50_cls',
      'backbone_param': {'in_channels': 5, 'num_classes': 2},
      'use_rgb': True}
_PATCH = {'trainval_dataset': 'SupOcclusionOrderDataset', 'input_size': 256,
          'patch_or_image': 'patch', 'enlarge_box': 3.0,
          'use_category': False, 'remove_occ_bidirec': 0}
_TB = {'tensorboard': True, 'wandb': False}
TESTER_CONFIGS = {
    'InstaOrder/InstaOrderNet_o': {
        'model': _O, 'data': dict(_PATCH, dataset='InstaOrder'),
        'trainer': _TB},
    'InstaOrder/OrderNet': {
        'model': dict(_O, algo='OrderNet', backbone_param={
            'in_channels': 5, 'num_classes': 3}),
        'data': dict(_PATCH, dataset='InstaOrder'), 'trainer': _TB},
    'InstaOrder/OrderNet_ext': {
        'model': dict(_O, algo='OrderNet', backbone_param={
            'in_channels': 5, 'num_classes': 4}),
        'data': dict(_PATCH, dataset='InstaOrder'), 'trainer': _TB},
    'InstaOrder/InstaOrderNet_d': {
        'model': dict(_O, algo='InstaOrderNet_d', backbone_param={
            'in_channels': 5, 'num_classes': 3}),
        'data': {'dataset': 'InstaOrder',
                 'trainval_dataset': 'SupDepthOrderDataset',
                 'input_size': 384, 'patch_or_image': 'resize',
                 'enlarge_box': 3.0, 'use_category': False,
                 'remove_depth_overlap': 0},
        'trainer': {'wandb': False}},
    'InstaOrder/InstaOrderNet_od': {
        'model': dict(_O, algo='InstaOrderNet_od', backbone_param={
            'in_channels': 5, 'num_classes': [2, 3]}),
        'data': {'dataset': 'InstaOrder',
                 'trainval_dataset': 'SupDepthOccOrderDataset',
                 'input_size': 384, 'patch_or_image': 'resize',
                 'enlarge_box': 3.0, 'remove_occ_bidirec': 0,
                 'remove_depth_overlap': 0},
        'trainer': {'wandb': False}},
    'COCOA/InstaOrderNet_o': {
        'model': _O, 'data': dict(_PATCH, dataset='COCOA'), 'trainer': _TB},
    'KINS/InstaOrderNet_o': {
        'model': _O, 'data': dict(_PATCH, dataset='KINS'), 'trainer': _TB},
}
# (run name, config, order_method, pairs): every loop, both pair modes,
# the heuristics on InstaOrder (occlusion and depth) and on KINS
TESTER_RUNS = [
    ('InstaOrderNet_o', 'InstaOrder/InstaOrderNet_o', '', 'all'),
    ('InstaOrderNet_o nbor', 'InstaOrder/InstaOrderNet_o', '', 'nbor'),
    ('OrderNet', 'InstaOrder/OrderNet', '', 'all'),
    ('OrderNet_ext', 'InstaOrder/OrderNet_ext', '', 'all'),
    ('InstaOrderNet_d', 'InstaOrder/InstaOrderNet_d', '', 'all'),
    ('InstaOrderNet_od', 'InstaOrder/InstaOrderNet_od', '', 'all'),
    ('COCOA InstaOrderNet_o', 'COCOA/InstaOrderNet_o', '', 'all'),
    ('KINS InstaOrderNet_o', 'KINS/InstaOrderNet_o', '', 'all'),
    *((f'occ {m}', 'InstaOrder/InstaOrderNet_o', m, 'all')
      for m in ('area', 'yaxis', 'hull')),
    *((f'depth {m}', 'InstaOrder/InstaOrderNet_d', m, 'all')
      for m in ('area', 'yaxis')),
    *((f'KINS {m}', 'KINS/InstaOrderNet_o', m, 'all')
      for m in ('area', 'yaxis', 'hull')),
]


def _host(x):
    """numpy of a tensor (any device), a jax array, or a tuple of them."""
    import numpy as np
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_host(v) for v in x)
    if hasattr(x, 'detach'):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def record_tester(t):
    """Wrap a Tester (the port's or the JAX package's) so that each image
    leaves a record: its ground truth, its predicted matrices, the
    predictor's pair outputs (pair_idx, valid, out1, out2, n), the host
    ms from loading the image to its prediction (`ms`) and of the
    prediction alone (`predict_ms`). Returns the list of records,
    filled as t.run() goes."""
    log = []

    def wrap(obj, name, after, before=None):
        raw = getattr(obj, name)

        def fn(*a, **kw):
            if before:
                before()
            res = raw(*a, **kw)
            after(res, *a, **kw)
            return res
        setattr(obj, name, fn)

    def mark():
        log[-1]['t_pred'] = time.perf_counter()

    def load_scene(*a, **kw):
        log.append({'t0': time.perf_counter()})
        return raw_load(*a, **kw)
    raw_load = t._load_scene
    t._load_scene = load_scene

    def done(key):
        def after(res, *a, **kw):
            rec = log[-1]
            if isinstance(key, tuple):
                for k, v in zip(key, res):
                    rec[k] = v
            else:
                rec[key] = res
            rec['ms'] = (time.perf_counter() - rec['t0']) * 1e3
            rec['predict_ms'] = (time.perf_counter() - rec['t_pred']) * 1e3
        return after

    def gt(res, i, kind='occlusion', *a, **kw):
        log[-1]['gt_' + kind] = res
    wrap(t, '_gt_occ', lambda res, *a, **kw: log[-1].update(
        gt_occlusion=res))
    if hasattr(t.data_reader, 'get_gt_ordering'):     # not KINS's reader
        wrap(t.data_reader, 'get_gt_ordering', gt)
    wrap(t, '_predict_occ', done('occ'), mark)
    wrap(t, '_predict_depth', done('depth'), mark)
    prepare = t.prepare_model

    def prepare_model():
        prepare()
        pred = t.predictor
        # a DisparityOrderPredictor has neither: it orders by region
        # depths (record_region_depths), not by pair outputs
        if not hasattr(pred, 'infer_occ_depth_order'):
            return
        wrap(pred, 'infer_occ_depth_order', done(('occ', 'depth')), mark)
        name = ('pair_outputs' if hasattr(pred, 'pair_outputs')
                else '_pair_outputs')
        wrap(pred, name, lambda res, *a, **kw: log[-1].update(
            out=_host(res[:4]) + (res[4],)))
    t.prepare_model = prepare_model
    return log


def sure_cells(out, kind, margin=SURE_MARGIN):
    """(N, N) bool: the cells of a matrix decoded from `out` = (pair_idx,
    valid, out1, out2, n) whose decision is sure. kind 'occ' (sigmoid >
    0.5 of the two-logit head, each cell its own decision), 'ordernet'
    (argmax of the averaged 3- or 4-class softmax) or 'depth' (argmax of
    the averaged 3-way softmax; the pair's two cells one decision). The
    first head of a dual net is its occlusion head, the second its depth
    head. Padded and filtered pairs decide nothing (their cells are 0)."""
    import numpy as np
    pidx, valid, o1, o2, n = out
    pick = 1 if kind == 'depth' else 0
    if isinstance(o1, tuple):
        o1 = o1[pick]
        o2 = None if o2 is None else o2[pick]
    o1 = np.asarray(o1, np.float64)
    o2 = None if o2 is None else np.asarray(o2, np.float64)
    sure = np.ones((n, n), bool)

    def softmax(o):
        e = np.exp(o - o.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)
    if kind == 'occ':
        s1 = 1 / (1 + np.exp(-o1))
        if o2 is None:
            p_ij, p_ji = s1[:, 1], s1[:, 0]
        else:
            s2 = 1 / (1 + np.exp(-o2))
            p_ij = (s1[:, 1] + s2[:, 0]) / 2
            p_ji = (s1[:, 0] + s2[:, 1]) / 2
        m_ij, m_ji = np.abs(p_ij - 0.5), np.abs(p_ji - 0.5)
    else:
        s1 = softmax(o1)
        # the swapped direction's classes in the (i, j) order
        swap = ([1, 0, 2, 3] if kind == 'ordernet' else [1, 0, 2])
        swap = swap[:s1.shape[1]]
        p = s1 if o2 is None else (s1 + softmax(o2)[:, swap]) / 2
        top = np.sort(p, axis=1)
        m_ij = m_ji = top[:, -1] - top[:, -2]
    for k, (i, j) in enumerate(np.asarray(pidx)):
        if valid[k]:
            sure[i, j] = m_ij[k] > margin
            sure[j, i] = m_ji[k] > margin
    return sure


def compare_tester_runs(name, method, got, want):
    """Hold one Tester run's records against the reference run's: ground
    truth and heuristic matrices equal everywhere, model matrices equal
    at every sure cell of the reference's outputs. Returns the counts of
    (sure decided cells, unsure cells, differing cells); where no cell
    differs, the metrics (a function of the matrices and the ground
    truth) must be equal."""
    import numpy as np
    check(len(got) == len(want) and len(got) > 0,
          f'{name}: {len(got)} images against {len(want)}')
    n_sure = n_unsure = n_diff = 0
    for k, (g, w) in enumerate(zip(got, want)):
        for key in ('gt_occlusion', 'gt_depth'):
            check((key in g) == (key in w), f'{name} image {k}: {key}')
            if key in w:
                for a, b in zip(*((x if isinstance(x, list) else [x])
                                  for x in (g[key], w[key]))):
                    check(np.array_equal(a, b), f'{name} image {k}: {key} '
                          'equal')
        for key in ('occ', 'depth'):
            if key not in w:
                continue
            a, b = np.asarray(g[key]), np.asarray(w[key])
            check(a.shape == b.shape, f'{name} image {k}: {key} shape')
            if 'out' not in w:          # a heuristic: no model
                check(np.array_equal(a, b), f'{name} image {k}: {key} '
                      'equal')
                continue
            kind = ('depth' if key == 'depth' else
                    'ordernet' if method == 'OrderNet' else 'occ')
            sure = sure_cells(w['out'], kind)
            check((a == b)[sure].all(), f'{name} image {k}: {key} equal at '
                  f'every sure cell ({int((a != b)[sure].sum())} differ)')
            # the decided cells: both cells of every valid pair
            pidx, valid = w['out'][0], np.asarray(w['out'][1], bool)
            decided = np.zeros_like(sure)
            decided[pidx[valid, 0], pidx[valid, 1]] = True
            decided |= decided.T
            n_sure += int((sure & decided).sum())
            n_unsure += int((~sure).sum())
            n_diff += int((a != b).sum())
    return n_sure, n_unsure, n_diff


def head_logits(t, n_images):
    """{head: (rows, classes) float64 logits} of a Tester's own net over
    every valid pair of its first n_images images, both directions."""
    import numpy as np
    t.prepare_model()
    out = {}
    for i in range(min(n_images, t.data_length)):
        modal, _, bboxes, _, _, image = t._load_scene(i)
        _, valid, o1, o2 = _host(t.predictor.pair_outputs(
            image.astype(np.float32), modal.astype(np.float32),
            bboxes.astype(np.float32))[:4])
        valid = valid.astype(bool)
        heads = (('fc_occ', 'fc_depth') if isinstance(o1, tuple)
                 else ('fc',))
        for k, h in enumerate(heads):
            for o in (o1, o2):
                o = o[k] if isinstance(o, tuple) else o
                out.setdefault(h, []).append(np.asarray(o, np.float64)[valid])
    return {h: np.concatenate(v) for h, v in out.items()}


def centre_heads(params, logits, spread=LOGIT_SPREAD):
    """Shift and scale each head of a numpy params tree so that its
    `logits` (head_logits of the same net) get mean 0 per class and
    standard deviation `spread`. A random net's logits share one large
    part across all pairs: scaled up, it saturates every pair and both
    swap directions to the same class, which leaves the swap-averaged
    decisions on their thresholds (nothing sure); centred, the logits
    are the part that depends on the pair and its direction."""
    out = dict(params)
    for h, z in logits.items():
        mu = z.mean(axis=0)
        g = spread / max(float((z - mu).std()), 1e-30)
        w, b = params[h]['w'], params[h]['b']
        out[h] = {'w': (w * g).astype(w.dtype),
                  'b': ((b - mu) * g).astype(b.dtype)}
    return out


def instaorder_fixture(root, hw=(HEIGHT, WIDTH)):
    """The phases' InstaOrder fixture (data/synthetic.py, seed 0):
    TESTER_IMAGES images of hw, TESTER_INSTANCES instances each, written
    under root; (annotation file, image root)."""
    from instaorder_tpu_torch.data import synthetic
    insta, _, img = synthetic.make_instaorder_fixture(
        root, n_images=TESTER_IMAGES, n_instances=TESTER_INSTANCES,
        h=hw[0], w=hw[1])
    return insta, img


def tester_args(cfg, root, fixtures, method, pairs, load_model):
    """The config namespace the Tester reads (cli/config.load_config's
    shape), on the fixture of cfg's dataset; tensorboard switched off
    (tensorboardX may be missing where this runs)."""
    import types
    ann, img = fixtures[cfg['data']['dataset']]
    a = types.SimpleNamespace()
    a.model = dict(cfg['model'])
    a.data = dict(cfg['data'], val_annot_file=ann, val_image_root=img)
    a.trainer = dict(cfg['trainer'], tensorboard=False)
    a.order_method = method
    a.pairs = pairs
    a.zd = 0
    a.load_model = load_model
    a.out_dir = root
    return a


def tester_net(torch, cfg, root, fixtures, step):
    """The checkpoint of one Tester configuration, written with the
    port's save_state: the net at full width from seed 0 (kaiming), its
    heads centred on the card over the fixture's first CENTRE_IMAGES
    images (centre_heads). Returns the path."""
    import os
    import logging
    from instaorder_tpu_torch.convert import to_numpy
    from instaorder_tpu_torch.core import checkpoint as CK
    from instaorder_tpu_torch.eval.tester import Tester
    from instaorder_tpu_torch.models.registry import get_backbone
    params, stats, _ = get_backbone(cfg['model']['backbone_arch'])['init'](
        torch.Generator().manual_seed(0), weight_init='kaiming_out',
        device='cpu', **cfg['model']['backbone_param'])
    params, stats = to_numpy(params), to_numpy(stats)
    raw = CK.save_state(f'{root}/raw', 0, params, stats)
    t = Tester(tester_args(cfg, root, fixtures, '', 'all', raw),
               logger=logging.getLogger('chip_smoke.tester'))
    params = centre_heads(params, head_logits(t, CENTRE_IMAGES))
    os.remove(raw)
    return CK.save_state(f'{root}/net', step, params, stats)


def tester_cpu(args):
    """Reference job of phase 5: Tester(args) on the CPU over the first
    TESTER_CPU_IMAGES images, with its records (record_tester); (records,
    result)."""
    from instaorder_tpu_torch.eval.tester import Tester
    t = Tester(args, logger=quiet_tester_log('chip_smoke.tester'),
               device='cpu', n_images=TESTER_CPU_IMAGES)
    recs = record_tester(t)
    return recs, t.run()


def first_tester_metrics(t, recs, n):
    """Tester t's metrics over its first n images' records, as its eval
    loop (by the config's trainval_dataset) gives them on n images."""
    tv = t.args.data['trainval_dataset']
    if tv == 'SupDepthOrderDataset':
        return first_metrics(t, recs, n)
    occ = first_occ_metrics(recs, n)
    if tv == 'SupDepthOccOrderDataset':
        del occ['n']
        return dict(first_metrics(t, recs, n), **occ)
    return occ


def phase_tester(torch, dev, card, wrappers, pool=None):
    """The Tester on the card and on the CPU: fixtures written by the
    port's data/synthetic.py, each net from seed 0 (tester_net) saved
    with the port's save_state and loaded through load_model; card and
    CPU records compared (the CPU's runs in `pool`, own_pool, compared
    when it finishes; the files live in its tempdir until then);
    per-image ms by run. Returns {run name: (per-image ms, of it the
    prediction's), medians after one warm-up image}."""
    import numpy as np
    from instaorder_tpu_torch import native
    from instaorder_tpu_torch.core import checkpoint as CK
    from instaorder_tpu_torch.data import rle, synthetic
    from instaorder_tpu_torch.eval.tester import Tester

    t0 = time.perf_counter()
    check(native.load() is not None and native.registered(),
          f'the native RLE codec is loaded and registered '
          f'({native.LOAD_ERROR})')
    print(f'native RLE codec: {sorted(rle._NATIVE)}')
    log = quiet_tester_log('chip_smoke.tester')
    timing = {}
    with own_pool(pool) as pool:
        root = pool.tempdir()
        fixtures = {'InstaOrder': instaorder_fixture(root),
                    'COCOA': synthetic.make_cocoa_fixture(root),
                    'KINS': synthetic.make_kins_fixture(root)}
        net, net_of = None, None
        for step, (name, cname, method, pairs) in enumerate(TESTER_RUNS):
            cfg = TESTER_CONFIGS[cname]
            if not method and net_of != cname:
                net, net_of = tester_net(torch, cfg, root, fixtures,
                                         1000 + step), cname
            args = tester_args(cfg, root, fixtures, method, pairs,
                               None if method else net)
            t = Tester(args, logger=log, device=None)
            recs = record_tester(t)
            for w in wrappers.values():
                w.launches = 0
            with quiet():
                res = t.run()
            torch.cuda.synchronize()
            got = {n: w.launches for n, w in wrappers.items() if w.launches}
            check(not got, f'tester {name}: no kernel launched (as JAX\'s '
                  f'Tester reaches none): {got}')
            check(method or t.predictor.device.type == 'cuda',
                  f'tester {name}: the predictor is on the card')
            check(method or t.curr_step == CK.parse_iter(net),
                  f'tester {name}: the checkpoint\'s step loaded')
            med = lambda k: float(np.median([r[k] for r in  # noqa: E731
                                             recs[1:]]))
            timing[name] = (med('ms'), med('predict_ms'))
            print(f'  tester {name}: {res} on the card; per image '
                  f'{timing[name][0]:.3f} ms')

            first = first_tester_metrics(t, recs, TESTER_CPU_IMAGES)

            def then(cpu, name=name, algo=cfg['model']['algo'], recs=recs,
                     first=first):
                want, want_res = cpu
                sure, unsure, differ = compare_tester_runs(
                    name, algo, recs[:TESTER_CPU_IMAGES], want)
                if not differ:
                    check(first == want_res, f'tester {name}: metrics on the '
                          f'first {TESTER_CPU_IMAGES} images equal ({first} '
                          f'vs {want_res})')
                print(f'  tester {name}: card vs CPU (first '
                      f'{TESTER_CPU_IMAGES} images): {sure} sure cells equal, '
                      f'{unsure} unsure, {differ} differ; metrics '
                      f'{"equal" if not differ else "not held"}')
            pool.later(f'tester CPU runs: {name}', tester_cpu, args,
                       then=then)
        print(f'tester phase (the card\'s runs): '
              f'{time.perf_counter() - t0:.1f} s')
        for name, (ms, pred_ms) in timing.items():
            print(f'tester {name}: {ms:.3f} ms per image on the card, '
                  f'{pred_ms:.3f} of it the prediction (host clock, median '
                  f'after one warm-up image; {card})')
    return timing


# ---- training (train/trainer.py, JAX's trainer.py counterpart) ---------------
# the nets of experiments/InstaOrder/ that the port trains (each at its
# config.yaml's settings)
TRAIN_NETS = ('InstaOrderNet_o', 'OrderNet', 'OrderNet_ext',
              'InstaOrderNet_d', 'InstaOrderNet_od')
# the card-vs-CPU step: pairs, and the bars (against the CPU's f64 step)
XDEV_PAIRS = 4
XDEV_LOSS_BAR = 1e-5        # relative
XDEV_UPDATE_BAR = 1e-3      # of each leaf's max |update on the CPU|
XDEV_STATS_BAR = 1e-5       # of each leaf's max |stat on the CPU|
# ... or this many times the CPU f32 run's own error on that leaf, where
# that is larger: the statistics of every phase (check_stats), phase 9's
# updates
XDEV_CPU_FACTOR = 2
TIMING_WARMUP, TIMING_REPS = 3, 10
# the loader-fed window: steps after a warm-up (the first batch waits for
# the whole prefetch), the logs read every LOADER_WARMUP steps; and the
# loader alone: batches after a warm-up (with no consumer beside it, its
# prefetch queue stays empty after the first batch)
LOADER_WARMUP, LOADER_WINDOW = 10, 20
ALONE_WARMUP, ALONE_WINDOW = 2, 10


def train_args(name, fixture, total_iter, data=None, dataset='InstaOrder',
               **trainer):
    """cli/config.load_config of experiments/<dataset>/<name>/config.yaml
    with the annotation and image paths on the fixture, total_iter, the
    `data` and trainer keys replaced, telemetry and the initial
    validation off (tensorboardX may be missing where this runs), seed
    0. The occlusion datasets iterate images, and the fixture has
    TESTER_IMAGES of them: their validation batch is cut to that, so
    that validate() sees a batch (a depth dataset iterates the 15 pairs
    of each image)."""
    import os
    from instaorder_tpu_torch.cli.config import load_config
    insta, img = fixture
    a = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 'experiments', dataset, name,
                                 'config.yaml'))
    a.model = dict(a.model, total_iter=total_iter)
    a.data = dict(a.data, train_annot_file=insta, val_annot_file=insta,
                  train_image_root=img, val_image_root=img, **(data or {}))
    if a.data['trainval_dataset'] == 'SupOcclusionOrderDataset':
        a.data['batch_size_val'] = min(a.data['batch_size_val'],
                                       TESTER_IMAGES)
    a.trainer = dict(a.trainer, tensorboard=False, wandb=False,
                     initial_val=False, **trainer)
    a.seed = 0
    return a


def quiet_logger(t):
    """Route a Trainer's log lines to its file only."""
    import logging
    for h in list(t.logger.handlers):
        if type(h) is logging.StreamHandler:
            t.logger.removeHandler(h)


def on_branch(torch, masks, flips):
    """A torch.relu that keeps the ReLU branch of `masks` (the CPU run's
    x > 0, in call order) and counts in flips[0] the inputs whose own
    sign disagrees: the gradient of a ReLU net jumps where an input
    crosses zero, and two f32 forwards put a few of its ~10^8 inputs on
    opposite sides."""
    real = torch.relu
    it = iter(masks)

    def relu(x):
        m = next(it).to(x.device)
        flips[0] += int(((x > 0) != m).sum())
        return torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
    return real, relu


def minmax_recorder(torch, TL, sets, flips=None):
    """A losses.min_max_norm that records, per image, the pixels that
    hold its min and its max (every tied pixel) into `sets`; with flips
    given, one that follows `sets` instead (each extremum the mean of the
    recorded pixels, so that its gradient splits over them as amin /
    amax split it over ties) and counts in flips[0] the extrema whose
    own pixels differ: the gradient of the normalisation goes to the
    extremal pixel, and two forwards can put a near-tie's maximum on
    different pixels."""
    real = TL.min_max_norm
    it = iter(sets)

    def mmn(disp, eps=1e-7):
        dims = (-2, -1)
        own = (disp == torch.amin(disp, dim=dims, keepdim=True),
               disp == torch.amax(disp, dim=dims, keepdim=True))
        if flips is None:
            sets.append(tuple(m.cpu() for m in own))
            return real(disp, eps)
        lo, hi = (m.to(disp.device) for m in next(it))
        for a, b in zip(own, (lo, hi)):
            flips[0] += int((a != b).flatten(1).any(1).sum())

        def ext(m):
            return (disp * m).sum(dim=dims, keepdim=True) / m.sum(
                dim=dims, keepdim=True)
        return (disp - ext(lo)) / (ext(hi) + eps)
    return mmn


def train_step_on(torch, T, ST, CV, net, cfg, m, params, stats, batch,
                  dev, branch=None, dtype=None, record=None, mesh=None):
    """One SGD step of the loss of model settings `m` (a configuration's
    `model` section) on `dev` from numpy params/stats and a numpy batch, in
    f32 (dtype None) or in `dtype` (params, stats and the batch's float
    fields cast); with a mesh, this rank's step of a data-parallel one
    (build_train_step(mesh=...): `batch` is the rank's shard, the gradients,
    statistics and logs averaged over the ranks). branch None: record the
    forward's ReLU masks, its max-pools' argmaxes (core/nn.max_pool: the
    UNet's 2x2 pools, the ResNet stems' 3x3) and its count of tied pool
    windows into a new branch (masks, indices, [ties]), returned; else
    follow them. record: a callback wrapped around the step (a context
    manager factory), or None. Returns (loss, new params, new stats (numpy),
    branch, (ReLU flips, pool argmax flips, of them not exact ties, of them
    beyond 1e-5; pool_recorder), the logs as floats)."""
    import contextlib
    from instaorder_tpu_torch import losses as TL
    from instaorder_tpu_torch.core import nn as CN
    from instaorder_tpu_torch.core.nn import tree_map
    from instaorder_tpu_torch.train import algos, optim
    loss_fn = algos.make_loss(m['algo'], net, cfg, m)
    opt = optim.make_optimizer('SGD', weight_decay=m['weight_decay'])
    step = ST.build_train_step(loss_fn, opt, mesh)
    cast = (lambda t: t) if dtype is None else \
        (lambda t: t.to(dtype) if t.is_floating_point() else t)
    p = tree_map(cast, CV.tree_to(CV.to_torch(params), dev))
    s = tree_map(cast, CV.tree_to(CV.to_torch(stats), dev))
    xb = {k: cast(v) for k, v in T.batch_to_device(batch, dev).items()}
    relu_flips, pool_flips, mm_flips = [0], [0, 0, 0], [0]
    real = torch.relu, CN.max_pool, TL.min_max_norm
    if branch is None:
        branch = ([], [], [0], [])

        def relu(x):
            branch[0].append((x > 0).cpu())
            return real[0](x)
        pool = pool_recorder(torch, branch[1], ties=branch[2])
        mmn = minmax_recorder(torch, TL, branch[3])
    else:
        _, relu = on_branch(torch, branch[0], relu_flips)
        pool = pool_recorder(torch, branch[1], pool_flips)
        mmn = minmax_recorder(torch, TL, branch[3], mm_flips)
    torch.relu, CN.max_pool, TL.min_max_norm = relu, pool, mmn
    try:
        with (record() if record else contextlib.nullcontext()):
            p, s, _, logs = step(p, s, opt.init(p), xb, m['lr'])
    finally:
        torch.relu, CN.max_pool, TL.min_max_norm = real
    return (float(logs['loss']), CV.to_numpy(p), CV.to_numpy(s), branch,
            (relu_flips[0], *pool_flips, mm_flips[0]),
            {k: float(v) for k, v in logs.items()})


def leaf_worst(got, want, base, what, on_tree_max=(), leaves=None):
    """(worst relative error, leaf path) over a tree's leaves: max |got -
    want| over max |want - base| (base None: over max |want|); for
    updates (base given) one f32 spacing of the value is allowed, the
    rounding of p - lr * buf. A leaf whose path ends in one of
    `on_tree_max` is held on the largest such scale of the whole tree
    instead of its own (a conv bias that feeds a train-mode BatchNorm:
    its gradient is 0, its update rounding). leaves: a dict that gets
    {path: (error, scale)} of every leaf."""
    import numpy as np
    out = (0.0, '')
    tree_max = [0.0]

    def scale_of(w, b):
        w = np.asarray(w, np.float64)
        return float(np.abs(w if b is None else
                            w - np.asarray(b, np.float64)).max())

    def walk_max(w, b):
        if isinstance(w, dict):
            for k in w:
                walk_max(w[k], None if b is None else b[k])
        elif isinstance(w, (list, tuple)):
            for i in range(len(w)):
                walk_max(w[i], None if b is None else b[i])
        else:
            tree_max[0] = max(tree_max[0], scale_of(w, b))
    walk_max(want, base)

    def walk(g, w, b, path):
        nonlocal out
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], None if b is None else b[k], f'{path}.{k}')
        elif isinstance(w, (list, tuple)):
            for i in range(len(w)):
                walk(g[i], w[i], None if b is None else b[i], f'{path}[{i}]')
        else:
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            err = np.abs(g - w)
            scale = scale_of(w, b)
            if b is not None:
                err = err - np.spacing(np.abs(w).astype(np.float32))
            if path.endswith(tuple(on_tree_max)):
                scale = tree_max[0]
            rel = float(err.max()) / max(float(scale), 1e-30)
            if leaves is not None:
                leaves[path] = (rel, float(scale))
            out = max(out, (rel, path))
    walk(got, want, base, what)
    return out


def leaf_errors(got, want):
    """{leaf path: max |got - want| / max |want|} over a tree's leaves."""
    import numpy as np
    out = {}

    def walk(g, w, path):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f'{path}.{k}')
        elif isinstance(w, (list, tuple)):
            for i in range(len(w)):
                walk(g[i], w[i], f'{path}[{i}]')
        else:
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            out[path] = float(np.abs(g - w).max()) / max(
                float(np.abs(w).max()), 1e-30)
    walk(got, want, 'stats')
    return out


def check_stats(name, sg, s32, s64, card, factor=XDEV_CPU_FACTOR):
    """The card's new statistics (sg) against the CPU's f64 ones (s64):
    each leaf within max(XDEV_STATS_BAR, XDEV_CPU_FACTOR x the CPU f32
    run's own error on that leaf), the CPU f32 run (s32) being exact in
    JAX's sense; prints the worst leaf's two errors."""
    e_card, e_cpu = leaf_errors(sg, s64), leaf_errors(s32, s64)
    bar = {k: max(XDEV_STATS_BAR, factor * e_cpu[k]) for k in e_card}
    worst = max(e_card, key=lambda k: e_card[k] / bar[k])
    over = sum(e_card[k] > XDEV_STATS_BAR for k in e_card)
    print(f'  {name} new statistics vs CPU f64: worst card leaf {worst} '
          f'{e_card[worst]:.3e} (the CPU f32 run {e_cpu[worst]:.3e}, bar '
          f'{bar[worst]:.3e}); the card\'s worst {max(e_card.values()):.3e}'
          f', the CPU f32 run\'s worst {max(e_cpu.values()):.3e}; {over} of '
          f'{len(e_card)} card leaves above {XDEV_STATS_BAR} ({card})')
    check(e_card[worst] <= bar[worst],
          f'{name}: every new statistic within max({XDEV_STATS_BAR}, '
          f'{factor} x the CPU f32 run\'s error) of f64 ({worst})')


def train_xdev_cpu(name):
    """Reference job of phase 6 for `name`: its net at full width (seed 0,
    kaiming) and XDEV_PAIRS pairs of the port's dataset on the InstaOrder
    fixture; the CPU's f64 step (recording the ReLU branch and the stem
    pool's argmaxes) and its f32 step on that branch. numpy."""
    import tempfile
    import torch
    from instaorder_tpu_torch import convert as CV
    from instaorder_tpu_torch.data.datasets import DATASETS, collate
    from instaorder_tpu_torch.data.loader import sample_rng
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.train import step as ST
    from instaorder_tpu_torch.train import trainer as T
    cpu = torch.device('cpu')
    with tempfile.TemporaryDirectory() as root:
        args = train_args(name, instaorder_fixture(root), 1)
        net = get_backbone('resnet50_cls')
        params, stats, cfg = net['init'](
            torch.Generator().manual_seed(0), weight_init='kaiming_out',
            device='cpu', **args.model['backbone_param'])
        params, stats = CV.to_numpy(params), CV.to_numpy(stats)
        ds = DATASETS[args.data['trainval_dataset']](args.data, 'train',
                                                     args.model['algo'])
        batch = collate([ds.sample(i % len(ds), sample_rng(0, i))
                         for i in range(XDEV_PAIRS)])
    run = lambda branch=None, dtype=None: train_step_on(  # noqa: E731
        torch, T, ST, CV, net, cfg, args.model, params, stats, batch, cpu,
        branch, dtype)
    l64, p64, s64, branch, _, _ = run(None, torch.float64)
    l32, p32, s32, _, cflips, _ = run(branch)
    return dict(params=params, stats=stats, cfg=cfg, batch=batch,
                f64=(l64, p64, s64), f32=(l32, p32, s32, cflips),
                branch=host_tree(branch))


# phase 6's reference jobs: (pool label, job, its argument)
TRAIN_XDEV_REFS = {n: (f'train xdev CPU f64 + f32 steps {n}', train_xdev_cpu,
                       n) for n in ('InstaOrderNet_o', 'InstaOrderNet_od')}


def phase_train_xdev(torch, T, ST, CV, get_backbone, fixture, dev, card,
                     pool):
    """One SGD step of InstaOrderNet_o and of InstaOrderNet_od at full
    width on the card against the CPU's (train_xdev_cpu, from the pool):
    the same params (seed 0, kaiming), the same batch of XDEV_PAIRS pairs
    from the port's dataset. The CPU runs the step in f32 and in f64; the
    card's f32 step is held against the CPU's f64 one (the CPU's f32
    convolutions, oneDNN's, are the less exact of the two f32 runs: its
    step is printed beside, with its own distance from f64). Every run
    follows the ReLU branch and the stem pool's argmaxes of the CPU's f64
    run (on_branch, pool_recorder), so that no f32 rounding picks the
    branch; the number of ReLU inputs and pool windows whose own choice
    differs is printed."""
    import numpy as np
    for name in ('InstaOrderNet_o', 'InstaOrderNet_od'):
        ref = pool.result(*TRAIN_XDEV_REFS[name])
        params, stats, cfg, batch = (ref[k] for k in ('params', 'stats',
                                                      'cfg', 'batch'))
        l64, p64, s64 = ref['f64']
        l32, p32, s32, cflips = ref['f32']
        branch = torch_tree(torch, ref['branch'])
        args = train_args(name, fixture, 1)
        lg, pg, sg, _, flips, _ = train_step_on(
            torch, T, ST, CV, get_backbone('resnet50_cls'), cfg, args.model,
            params, stats, batch, dev, branch)
        out = {}
        for who, (l, p, s) in (('card f32', (lg, pg, sg)),
                               ('CPU f32', (l32, p32, s32))):
            out[who] = (abs(l - l64) / abs(l64),
                        leaf_worst(p, p64, params, 'params'),
                        leaf_worst(s, s64, None, 'stats'))
            lrel, upd, sts = out[who]
            print(f'train one SGD step {name} ({XDEV_PAIRS} pairs, '
                  f'{args.data["input_size"]}^2; {card}): {who} vs CPU '
                  f'f64: loss {l:.6f} vs {l64:.6f} (rel {lrel:.3e}); worst '
                  f'update {upd[1]} {upd[0]:.3e} of its max |update|; '
                  f'worst stats {sts[1]} {sts[0]:.3e}')
        print(f'train {name}: {flips[0]} (CPU f32 {cflips[0]}) of '
              f'{sum(int(m.numel()) for m in branch[0])} ReLU inputs and '
              f'{flips[1]} (CPU f32 {cflips[1]}) of '
              f'{sum(int(i.numel()) for i in branch[1])} pool argmaxes on '
              f'the other side on the card (every run follows the CPU f64 '
              f'run\'s branch); card vs CPU f32: worst update '
              f'{leaf_worst(pg, p32, params, "params")}')
        lrel, upd, sts = out['card f32']
        check(np.isfinite(lg) and lrel <= XDEV_LOSS_BAR,
              f'{name}: card loss within {XDEV_LOSS_BAR} of the CPU\'s')
        check(upd[0] <= XDEV_UPDATE_BAR,
              f'{name}: every update within {XDEV_UPDATE_BAR} ({upd})')
        check_stats(name, sg, s32, s64, card)


def time_train_step(torch, T, t, batch):
    """Device ms of the Trainer's train step on a fixed batch already on
    the card: median of TIMING_REPS after TIMING_WARMUP, each
    synchronised; and the peak memory of those steps (GiB)."""
    import numpy as np
    xb = T.batch_to_device(batch, t.device)
    p, s, o = t.params, t.stats, t.opt_state
    lr = t.lr_fn(0)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with quiet():
        for i in range(TIMING_WARMUP + TIMING_REPS):
            t0 = time.perf_counter()
            p, s, o, logs = t.train_step(p, s, o, xb, lr)
            torch.cuda.synchronize()
            if i >= TIMING_WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
    check(np.isfinite(float(logs['loss'])), 'timed steps: finite loss')
    return (float(np.median(times)),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def time_loader_fed(T, name, fixture, out_dir, data=None,
                    warmup=LOADER_WARMUP, window=LOADER_WINDOW):
    """The loader-fed Trainer over a steady window, and its loader alone.

    A Trainer of `name` at its YAML's settings (the `data` keys
    replaced) trains warmup + window steps (LOADER_WARMUP and
    LOADER_WINDOW by default), its logs read (the card synchronised)
    every `warmup` steps; its own meters,
    btime and dtime, are reset and unwindowed as the loader hands over
    the first batch after the warm-up. A print_freq read lands in the
    next step's data time, so the window's batch times sum to its wall
    time. Then a fresh pass of the same loader, with nothing beside it:
    ms a batch over ALONE_WINDOW batches after ALONE_WARMUP. Returns
    (batch ms, data ms, loader-alone ms, the Trainer, a batch)."""
    args = train_args(name, fixture, warmup + window, data,
                      print_freq=warmup, val_iter=1)
    t = T.Trainer(args, out_dir=out_dir)
    quiet_logger(t)
    make = t._make_loader

    def windowed(phase):
        loader = make(phase)
        if phase != 'train':
            return loader

        def batches():
            for i, b in enumerate(loader):
                if i == warmup:
                    for m in (t.btime, t.dtime):
                        m.length = 0
                        m.reset()
                yield b
        return batches()
    t._make_loader = windowed
    with quiet():
        t.train()
    check(t.curr_step == warmup + window and
          t.btime.count == window == t.dtime.count,
          f'{name}: a loader-fed window of {window} steps')
    with quiet():
        it = iter(make('train'))
        for _ in range(ALONE_WARMUP):
            next(it)
        t0 = time.perf_counter()
        for _ in range(ALONE_WINDOW):
            batch = next(it)
        alone = (time.perf_counter() - t0) / ALONE_WINDOW * 1e3
    it.close()
    return t.btime.avg * 1e3, t.dtime.avg * 1e3, alone, t, batch


def train_flow(torch, T, name, fixture, out, tester_cfg,
               dataset='InstaOrder'):
    """The Trainer's full flow at experiments/<dataset>/<name>'s settings
    on the card: 4 steps, a checkpoint, a new Trainer resuming it
    (start_iter 4, params equal) to 6, validate() finite, and the Tester
    (tester_cfg) on the step-6 checkpoint."""
    import os
    import numpy as np
    from instaorder_tpu_torch.core.nn import tree_leaves
    from instaorder_tpu_torch.eval.tester import Tester
    flow = dict(print_freq=2, save_freq=4, val_iter=2)
    t = T.Trainer(train_args(name, fixture, 4, dataset=dataset, **flow),
                  out_dir=out)
    quiet_logger(t)
    check(t.device.type == 'cuda', f'{name}: the Trainer runs on the card')
    t.train()
    ck4 = f'{out}/checkpoints/ckpt_iter_4.ckpt'
    check(t.curr_step == 4 and os.path.isfile(ck4),
          f'{name}: 4 steps and a checkpoint at 4')
    t2 = T.Trainer(train_args(name, fixture, 6, dataset=dataset, **flow),
                   out_dir=f'{out}2')
    quiet_logger(t2)
    t2.load(ck4, resume=True)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(t.params),
                                                 tree_leaves(t2.params)))
    check(t2.start_iter == 4 and same,
          f'{name} resume: start_iter 4 and the params equal')
    t2.train()
    val = t2.validate()
    check(t2.curr_step == 6 and np.isfinite(val['loss']),
          f'{name}: resumed to 6 and validate() is finite ({val})')
    root = os.path.dirname(out)
    tester = Tester(tester_args(tester_cfg, root, {dataset: fixture}, '',
                                'all', f'{out}2/checkpoints/ckpt_iter_6.ckpt'),
                    logger=t2.logger)
    res = tester.run()
    check(tester.curr_step == 6 and np.isfinite(res['f1']),
          f'{name}: the Tester on the step-6 checkpoint ({res})')
    d = t2.args.data
    print(f'train flow {dataset}/{name} ({t2.args.model["backbone_arch"]}, '
          f'{d["input_size"]}^2, batch {d["batch_size"]}): 4 steps, '
          f'checkpoint, resume, 6 steps, validate loss {val["loss"]:.4f}, '
          f'Tester {res}')


def three_steps(torch, T, name, fixture, out, dataset='InstaOrder',
                every_leaf=True, data=None):
    """experiments/<dataset>/<name> at its own settings on the card: 3
    finite steps that move every param leaf (every_leaf False: the leaves
    moved are counted, not held: InstaDepthNet_od's YAML trains little
    but the disparity path, and at its lr an update below half an f32
    spacing leaves a weight as it was)."""
    import numpy as np
    from instaorder_tpu_torch.core.nn import tree_leaves
    ta = T.Trainer(train_args(name, fixture, 3, data=data, dataset=dataset,
                              print_freq=1, val_iter=1), out_dir=out)
    dataset = ta.args.data['dataset']
    quiet_logger(ta)
    before = [x.clone() for x in tree_leaves(ta.params)]
    seen = []
    real = ta.train_step

    def step(*a):
        out = real(*a)
        seen.append(out[3]['loss'])
        return out
    ta.train_step = step
    ta.train()
    losses = [float(v) for v in seen]
    moved = sum(not torch.equal(a, b) for a, b in zip(
        before, tree_leaves(ta.params)))
    check(len(losses) == 3 and np.isfinite(losses).all(),
          f'{dataset}/{name}: 3 finite steps ({losses})')
    check(moved == len(before) or not every_leaf,
          f'{dataset}/{name}: every param leaf moved ({moved} of '
          f'{len(before)})')
    print(f'train {dataset}/{name} ({ta.args.data["input_size"]}^2, '
          f'{ta.args.data["patch_or_image"]}, batch '
          f'{ta.args.data["batch_size"]}): losses {losses}; {moved} of '
          f'{len(before)} param leaves moved')


def phase_train(torch, dev, card, wrappers, pool=None):
    """Training on the card (module docstring, phase 6), its CPU
    references from `pool` (own_pool). Returns {run: numbers}."""
    import tempfile
    from instaorder_tpu_torch import convert as CV
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.train import step as ST
    from instaorder_tpu_torch.train import trainer as T

    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    numbers = {}
    with tempfile.TemporaryDirectory() as root, own_pool(pool) as pool:
        fixture = instaorder_fixture(root)
        train_flow(torch, T, 'InstaOrderNet_o', fixture, f'{root}/o',
                   TESTER_CONFIGS['InstaOrder/InstaOrderNet_o'])
        # every ported algorithm at its own settings: 3 finite steps that
        # move the params
        for name in TRAIN_NETS:
            three_steps(torch, T, name, fixture, f'{root}/{name}')

        phase_train_xdev(torch, T, ST, CV, get_backbone, fixture, dev, card,
                         pool)

        # the numbers: the loader-fed Trainer over a steady window and its
        # loader alone (_o also with process workers), and the device step
        # on a fixed batch, for _o at 256^2 and _od at 384^2
        for run, name, data in (
                ('o', 'InstaOrderNet_o', None),
                ('o process', 'InstaOrderNet_o', {'loader_mode': 'process'}),
                ('od', 'InstaOrderNet_od', None)):
            bt, dt, alone, ta, batch = time_loader_fed(
                T, name, fixture, f'{root}/{run}', data)
            d = ta.args.data
            numbers[run] = {'size': d['input_size'], 'batch': d['batch_size'],
                            'workers': d['workers'],
                            'mode': d.get('loader_mode', 'thread'),
                            'batch_ms': bt, 'data_ms': dt, 'alone_ms': alone}
            if data is None:
                ms, peak = time_train_step(torch, T, ta, batch)
                numbers[run].update(step_ms=ms, peak_gib=peak)
            del ta
    torch.cuda.synchronize()
    got = {n: w.launches for n, w in wrappers.items() if w.launches}
    check(not got, f'training launched no hand-written kernel: {got}')
    print(f'train phase: {time.perf_counter() - t0:.1f} s')
    for run, n in numbers.items():
        head = f'train InstaOrderNet_{run.split()[0]} {n["size"]}^2 batch ' \
               f'{n["batch"]} pairs'
        if 'step_ms' in n:
            print(f'{head}: device step {n["step_ms"]:.2f} ms (median of '
                  f'{TIMING_REPS} after {TIMING_WARMUP}, fixed batch on the '
                  f'card) = {n["batch"] / n["step_ms"] * 1e3:.1f} pairs/s, '
                  f'peak memory {n["peak_gib"]:.2f} GiB ({card})')
        print(f'{head}, {n["workers"]} {n["mode"]} workers: Trainer '
              f'loader-fed batch time {n["batch_ms"]:.2f} ms = '
              f'{n["batch"] / n["batch_ms"] * 1e3:.1f} pairs/s, data time '
              f'{n["data_ms"]:.2f} ms (host clock, steps '
              f'{LOADER_WARMUP + 1}-{LOADER_WARMUP + LOADER_WINDOW}); the '
              f'loader alone {n["alone_ms"]:.2f} ms a batch (batches '
              f'{ALONE_WARMUP + 1}-{ALONE_WARMUP + ALONE_WINDOW}; {card})')
    return numbers


# ---- the MiDaS family (models/midas.py, eval/disp.py) ------------------------
# the InstaDepthNet order heads at their config's batch (batch_size 12)
MIDAS_OD_BATCH = 12
# mask pairs of the card-vs-CPU forward of _d / _od
MIDAS_PAIRS = 4
# the bar of a card forward against the CPU's, of max |CPU output|
MIDAS_BAR = 1e-5
# the share of positive disparity pixels below which out_conv3's bias is
# raised (positive_disparity)
POSITIVE_SHARE = 0.99
# a region-depth comparison is sure when the two depths are more than
# this apart, relative; a DIW point pair when its two disparities are
DEPTH_SURE = 1e-3
DIW_SURE = 1e-4
DENSE_BAR = 1e-4            # the 8 dense metrics, card vs CPU, relative
DIW_IMAGES, KITTI_IMAGES, NYU_IMAGES = 8, 4, 2
# the Tester images whose matrices the CPU's are held against
MIDAS_CPU_IMAGES = 2
# the head's first conv (out_conv1) at the maps that chose its route
# (models/midas._conv_without_cudnn): (batch, height, width); 1x192^2 is
# a 384^2 input's, 12x192x608 a KITTI batch's
HEAD_CONV_SHAPES = ((1, 192, 192), (12, 96, 96), (12, 192, 608))
# (run name, config, disp_select_method, pairs) of the Tester's
# disparity route
DISP_RUNS = [
    ('midas_pretrained', 'InstaOrder/midas_pretrained', '', 'all'),
    ('InstaDepthNet_d median', 'InstaOrder/InstaDepthNet_d', 'median',
     'all'),
    ('InstaDepthNet_d median nbor', 'InstaOrder/InstaDepthNet_d', 'median',
     'nbor'),
    ('InstaDepthNet_d mean', 'InstaOrder/InstaDepthNet_d', 'mean', 'all'),
]


def median_ms(torch, fn, warmup=TIMING_WARMUP, reps=TIMING_REPS):
    """Median device ms of fn() (CUDA events around each call) over reps
    calls after warmup."""
    import numpy as np
    return float(np.median(event_ms(torch, fn, warmup, reps)))


def event_ms(torch, fn, warmup=TIMING_WARMUP, reps=TIMING_REPS):
    """The ms of each of reps calls of fn() after warmup, CUDA events
    around each call."""
    times = []
    with quiet():
        for i in range(warmup + reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            if i >= warmup:
                times.append(a.elapsed_time(b))
    return times


def midas_image(torch, fixture_image, dev):
    """The DisparityOrderPredictor's input of one fixture image: cubic to
    384^2, rounded, ImageNet-normalised; (1, 384, 384, 3) on dev."""
    import numpy as np
    from instaorder_tpu_torch.ops.pairs import _normalize
    from instaorder_tpu_torch.ops.resize import resize
    img = torch.as_tensor(np.asarray(fixture_image, np.float32), device=dev)
    rgb = resize(img.permute(2, 0, 1), 384, 384, 'cubic').permute(1, 2, 0)
    return _normalize(torch.clamp(torch.round(rgb), 0, 255))[None]


def positive_disparity(torch, M, p, s, cfg, xs):
    """Raise out_conv3's bias of p (in place) so that the disparity of
    each input of xs is positive on at least POSITIVE_SHARE of its
    pixels (the shift puts each one's 0.2% quantile above zero). The head
    ends in ReLUs: a random net's disparity is 0 on much of the image,
    where every region depth is 1e6 and every pair is "equal", which
    would leave the card-vs-CPU checks vacuous (as centre_heads does for
    the order heads). Returns (the least share before, after, the
    shift)."""
    def shares():
        with torch.no_grad():
            return [M.apply_disp(p, s, dict(cfg, non_negative=False), x)
                    for x in xs]
    pre = shares()
    before = min(float((v > 0).float().mean()) for v in pre)
    shift = 0.0
    if before < POSITIVE_SHARE:
        shift = max(float(-torch.quantile(v.reshape(-1), 0.002) +
                          0.05 * v.std()) for v in pre)
        p['out_conv3']['b'] = p['out_conv3']['b'] + shift
    after = min(float((v > 0).float().mean()) for v in shares())
    return before, after, shift


def worst_rel(got, want):
    """max |got - want| over max |want| (want on the CPU)."""
    return float((got.cpu() - want).abs().max() / want.abs().max())


def record_region_depths(TD, log):
    """Wrap eval/decode.region_depths so that each Tester image's record
    (record_tester's log) gets the region depths of its instances.
    Returns a function that removes the wrap."""
    raw = TD.region_depths

    def fn(*a, **kw):
        out = raw(*a, **kw)
        log[-1]['depths'] = out.detach().cpu().numpy()
        return out
    TD.region_depths = fn
    return lambda: setattr(TD, 'region_depths', raw)


def sure_depth_cells(depths, pairs_matrix, margin=DEPTH_SURE):
    """(N, N) bool: the cells whose decision the region depths make
    surely: both finite and more than `margin` apart, relative, or both
    NaN (a vanished instance: "equal" either way)."""
    import numpy as np
    d = np.asarray(depths, np.float64)
    a, b = d[:, None], d[None, :]
    nan = np.isnan(a) | np.isnan(b)
    sure = np.where(nan, np.isnan(a) & np.isnan(b),
                    np.abs(a - b) > margin * np.maximum(np.abs(a),
                                                        np.abs(b)))
    return sure | (pairs_matrix == 0) & (pairs_matrix.T == 0)


def compare_disp_runs(name, got, want):
    """The card's first images against the CPU's: ground truth equal,
    region-depth NaNs at the same instances, matrices equal at every sure
    cell (of the CPU's depths). Returns (sure cells, unsure, differing)."""
    import numpy as np
    check(len(want) == MIDAS_CPU_IMAGES and len(got) >= len(want),
          f'{name}: {len(got)} card images against {len(want)}')
    n_sure = n_unsure = n_diff = 0
    for k, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g['gt_depth'], w['gt_depth']):
            check(np.array_equal(a, b), f'{name} image {k}: gt equal')
        check(np.array_equal(np.isnan(g['depths']), np.isnan(w['depths'])),
              f'{name} image {k}: the same instances vanish')
        a, b = np.asarray(g['depth']), np.asarray(w['depth'])
        sure = sure_depth_cells(w['depths'], b)
        check((a == b)[sure].all(), f'{name} image {k}: matrices equal at '
              f'every sure cell ({int((a != b)[sure].sum())} differ)')
        off = ~np.eye(len(a), dtype=bool)
        n_sure += int((sure & off).sum())
        n_unsure += int((~sure).sum())
        n_diff += int((a != b).sum())
    return n_sure, n_unsure, n_diff


def first_metrics(t, recs, n):
    """The Tester's WHDR metrics over its first n images' records (as its
    eval_depth_order would give them on n images)."""
    import collections
    from instaorder_tpu_torch.eval.metrics import eval_depth_order_whdr
    acc = collections.defaultdict(list)
    for r in recs[:n]:
        for k, v in eval_depth_order_whdr(r['depth'], r['gt_depth']).items():
            acc[k].append(v[0])
    return t._finish_whdr(acc)


def disp_config(cname):
    """cli/config.load_config of experiments/<cname>/config.yaml, read by
    PyYAML as cli/test_disp reads it."""
    import os
    from instaorder_tpu_torch.cli.config import load_config
    return load_config(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), 'experiments', *cname.split('/'), 'config.yaml'))


def tester_disp_config(cname):
    """disp_config(cname) as the {model, data, trainer} dict that
    tester_args reads."""
    a = disp_config(cname)
    return {'model': a.model, 'data': a.data, 'trainer': a.trainer}


def disp_config_file(root, cname, ann, img, dataset):
    """A config file for cli/test_disp: experiments/<cname>/config.yaml
    with its annotation and image paths on a fixture of `dataset`,
    base_dir '' and tensorboard off. Returns its path."""
    import os
    import yaml
    raw = disp_config(cname).raw
    raw = dict(raw, trainer=dict(raw['trainer'], tensorboard=False),
               data=dict(raw['data'], base_dir='', val_annot_file=ann,
                         val_image_root=img, dataset=dataset))
    path = os.path.join(root, f'{dataset}.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    return path


def traced_forward(torch, fn, out_dir):
    """One fn() call (after a warm one) under torch.profiler, CUDA
    activity: (device-busy ms, the ms from its first device op's start to
    its last one's end, device ops), from the kernels, memcpys and
    memsets of its chrome trace; (None, None, 0) where the trace holds
    none. The busy time is the union of their intervals."""
    import os
    from torch.profiler import ProfilerActivity, profile
    with quiet():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    path = os.path.join(out_dir, 'midas_trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    spans = sorted((e['ts'], e['ts'] + e['dur'])
                   for e in trace.get('traceEvents', [])
                   if e.get('ph') == 'X' and e.get('cat') in
                   ('kernel', 'gpu_memcpy', 'gpu_memset'))
    if not spans:
        return None, None, 0
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3, (end - spans[0][0]) / 1e3, len(spans)


def head_conv_routes(torch, M, cnn, p, dev, card, numbers):
    """The head's first conv (p: out_conv1, features -> 128, 3x3, padding
    1) on the port's route (M._conv_without_cudnn) and through cuDNN
    (core/nn.conv2d, TF32 off) at HEAD_CONV_SHAPES: ms of each (median of
    5 after 2, CUDA events), the port's within MIDAS_BAR of max |cuDNN|."""
    g = torch.Generator(device=dev).manual_seed(0)
    for b, h, w in HEAD_CONV_SHAPES:
        x = torch.randn(b, h, w, p['w'].shape[2], device=dev, generator=g)
        want = cnn.conv2d(p, x, padding=1)
        err = worst_rel(M._conv_without_cudnn(p, x), want.cpu())
        check(err <= MIDAS_BAR, f'head conv {b}x{h}x{w}: the port\'s route '
              f'within {MIDAS_BAR} of max |cuDNN| ({err:.3g})')
        port = median_ms(torch, lambda: M._conv_without_cudnn(p, x), 2, 5)
        cudnn = median_ms(torch, lambda: cnn.conv2d(p, x, padding=1), 2, 5)
        numbers[f'head conv {b}x{h}x{w}'] = (port, cudnn)
        print(f'  head conv {b}x{h}x{w}: port route {port:.3f} ms, cuDNN '
              f'{cudnn:.3f} ms (median of 5 after 2), port within '
              f'{err:.3g} of max |cuDNN| ({card})')
        del x, want
    torch.cuda.empty_cache()


def midas_forward_cpu(path, x384, xk, m1, m2):
    """Reference job of phase 7 (a): the three nets that `path` holds
    (torch.save of {name: (params, stats, cfg)}, out_conv3's bias raised)
    on the CPU: MidasNet's disparity of x384 and of xk, _d's and _od's
    outputs on MIDAS_PAIRS copies of x384 with the mask pairs m1, m2.
    numpy."""
    import torch
    from instaorder_tpu_torch.models import midas as M
    nets = torch.load(path, weights_only=False)
    out = {}
    with torch.no_grad():
        p, s, cfg = nets['MidasNet']
        for what, x in (('384^2', x384), ('352x1216', xk)):
            out[what] = M.apply_disp(p, s, cfg, torch.from_numpy(x)).numpy()
        img = torch.from_numpy(x384).expand(MIDAS_PAIRS, -1, -1,
                                            -1).contiguous()
        for name in ('InstaDepthNet_d', 'InstaDepthNet_od'):
            p, s, cfg = nets[name]
            out[name] = host_tree(M.apply(p, s, cfg, img, torch.from_numpy(m1),
                                          torch.from_numpy(m2)))
    return out


def phase_midas_forward(torch, M, nets, x384, xk, pair_masks, card,
                        numbers, out_dir):
    """(a) and the forward timings of (d): each net's outputs on the card,
    one traced MidasNet forward of each shape, and the head conv's two
    routes. Returns the check of the card's outputs against the CPU's on
    the same trees (midas_forward_cpu's)."""
    import numpy as np
    from instaorder_tpu_torch.core import nn as cnn
    got = {}
    with torch.no_grad():
        p, s, cfg = nets['MidasNet']
        for what, x in (('384^2', x384), ('352x1216', xk)):
            got[what] = M.apply_disp(p, s, cfg, x).cpu()
            times = event_ms(torch, lambda: M.apply_disp(p, s, cfg, x))
            ms = float(np.median(times))
            numbers[f'MidasNet {what}'] = ms
            print(f'  MidasNet {what}: forward {ms:.3f} ms (batch 1, median '
                  f'of {TIMING_REPS} after {TIMING_WARMUP}, range '
                  f'{min(times):.3f}-{max(times):.3f}; {card})')
            busy, span, n_ops = traced_forward(
                torch, lambda: M.apply_disp(p, s, cfg, x), out_dir)
            if busy is None:
                print(f'  MidasNet {what} traced: the trace shows no device '
                      f'time; idle share not measured')
            else:
                numbers[f'MidasNet {what} device'] = (busy, span)
                print(f'  MidasNet {what} traced (torch.profiler): {n_ops} '
                      f'device ops, busy {busy:.3f} ms of a {span:.3f} ms '
                      f'device span (idle {100 * (1 - busy / span):.1f}%); '
                      f'busy against the untraced median: idle '
                      f'{100 * (1 - busy / ms):.1f}% ({card})')
        img = x384.expand(MIDAS_PAIRS, -1, -1, -1).contiguous()
        m1, m2 = pair_masks
        for name in ('InstaDepthNet_d', 'InstaDepthNet_od'):
            p, s, cfg = nets[name]
            got[name] = host_tree(M.apply(p, s, cfg, img, m1, m2))
        p, s, cfg = nets['InstaDepthNet_od']
        idx = np.arange(MIDAS_OD_BATCH) % MIDAS_PAIRS
        img = x384.expand(MIDAS_OD_BATCH, -1, -1, -1).contiguous()
        b1, b2 = m1[idx], m2[idx]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(torch, lambda: M.apply(p, s, cfg, img, b1, b2))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        numbers['InstaDepthNet_od batch 12'] = ms
        numbers['peak GiB'] = peak
        print(f'  InstaDepthNet_od batch {MIDAS_OD_BATCH} at 384^2 with '
              f'masks: {ms:.3f} ms ({MIDAS_OD_BATCH / ms * 1e3:.1f} pairs/s)'
              f', peak memory {peak:.2f} GiB ({card})')
        head_conv_routes(torch, M, cnn, nets['MidasNet'][0]['out_conv1'],
                         x384.device, card, numbers)

    def then(cpu):
        for what in ('384^2', '352x1216'):
            want = torch.from_numpy(cpu[what])
            err = worst_rel(got[what], want)
            share = float((want > 0).float().mean())
            check(err <= MIDAS_BAR, f'MidasNet {what}: card within '
                  f'{MIDAS_BAR} of max |CPU| ({err:.3g})')
            check(share >= POSITIVE_SHARE, f'MidasNet {what}: positive '
                  f'disparity on {share:.4f} of the pixels')
            print(f'  MidasNet {what}: disparity card vs CPU {err:.3g} of '
                  f'max |CPU| (bar {MIDAS_BAR}), {100 * share:.2f}% '
                  f'positive')
        for name in ('InstaDepthNet_d', 'InstaDepthNet_od'):
            errs = []
            for what, g, w in zip(('disparity', 'depth', 'occlusion'),
                                  got[name], cpu[name]):
                if w is None:
                    check(g is None, f'{name}: no {what} head')
                    continue
                g, w = torch.from_numpy(g), torch.from_numpy(w)
                errs.append((what, worst_rel(g, w)))
                check(errs[-1][1] <= MIDAS_BAR, f'{name} {what}: card within '
                      f'{MIDAS_BAR} of max |CPU| ({errs[-1][1]:.3g})')
                check(bool(torch.isfinite(w).all()), f'{name} {what} finite')
            print(f'  {name} on {MIDAS_PAIRS} mask pairs, card vs CPU of max '
                  f'|CPU|: ' + ', '.join(f'{w} {e:.3g}' for w, e in errs))
    return then


def midas_tester_cpu(args, select):
    """Reference job of phase 7 (b): the Tester's disparity route on the
    CPU over the first MIDAS_CPU_IMAGES images, its records with the
    region depths; (records, result)."""
    from instaorder_tpu_torch.eval import decode as TD
    from instaorder_tpu_torch.eval.pipeline import DisparityOrderPredictor
    from instaorder_tpu_torch.eval.tester import Tester
    t = Tester(args, logger=quiet_tester_log('chip_smoke.midas'),
               device='cpu', n_images=MIDAS_CPU_IMAGES)
    recs = record_tester(t)
    undo = record_region_depths(TD, recs)
    try:
        res = t.run()
    finally:
        undo()
    check(isinstance(t.predictor, DisparityOrderPredictor) and
          t.predictor.device.type == 'cpu' and
          t.predictor.select == (select or 'median'),
          f'tester {select}: the disparity predictor on the CPU, select '
          f'{select or "median"}')
    return recs, res


def phase_midas_tester(pool, dev, root, fixture, nets_ck, card, numbers):
    """(b): the Tester's disparity route on the card (every fixture image)
    against the CPU's (the first MIDAS_CPU_IMAGES; midas_tester_cpu in
    the pool, compared when it finishes)."""
    import numpy as np
    from instaorder_tpu_torch.eval import decode as TD
    from instaorder_tpu_torch.eval.pipeline import DisparityOrderPredictor
    from instaorder_tpu_torch.eval.tester import Tester
    for name, cname, select, pairs in DISP_RUNS:
        cfg = tester_disp_config(cname)
        args = tester_args(cfg, root, {'InstaOrder': fixture}, '', pairs,
                           nets_ck[cfg['model']['backbone_arch']])
        args.disp_select_method = select
        t = Tester(args, logger=quiet_tester_log('chip_smoke.midas'),
                   device=None, n_images=-1)
        recs = record_tester(t)
        undo = record_region_depths(TD, recs)
        try:
            with quiet():
                res = t.run()
        finally:
            undo()
        check(isinstance(t.predictor, DisparityOrderPredictor) and
              t.predictor.device.type == dev.type,
              f'tester {name}: the disparity predictor on the card')
        check(t.predictor.select == (select or 'median'),
              f'tester {name}: select {select or "median"}')
        first = first_metrics(t, recs, MIDAS_CPU_IMAGES)
        check(all(np.isfinite(v) for v in res.values()),
              f'tester {name}: finite metrics')
        med = lambda k: float(np.median([r[k] for r in  # noqa: E731
                                         recs[1:]]))
        numbers[f'tester {name}'] = (med('ms'), med('predict_ms'))
        print(f'  tester {name}: {res} on the card; per image '
              f'{med("ms"):.3f} ms, {med("predict_ms"):.3f} of it the '
              f'prediction (host clock, median after one warm-up image; '
              f'{card})')

        def then(cpu, name=name, recs=recs, first=first):
            want, want_res = cpu
            sure, unsure, differ = compare_disp_runs(name, recs, want)
            if not differ:
                check(first == want_res, f'tester {name}: metrics on the '
                      f'first {MIDAS_CPU_IMAGES} images equal ({first} vs '
                      f'{want_res})')
            print(f'  tester {name}: card vs CPU (first {MIDAS_CPU_IMAGES} '
                  f'images): {sure} sure cells equal, {unsure} unsure, '
                  f'{differ} differ; metrics '
                  f'{"equal" if not differ else "not held"}')
        pool.later(f'midas tester CPU runs: {name}', midas_tester_cpu, args,
                   select, then=then)


def test_disp_cpu(path, ck):
    """Reference job of phase 7 (c): cli/test_disp on the CPU with config
    `path` and checkpoint `ck`; its result."""
    import contextlib
    import io
    from instaorder_tpu_torch.cli import test_disp
    with contextlib.redirect_stdout(io.StringIO()):     # its logs
        return test_disp.main(['--config', path, '--load_model', ck,
                               '--device', 'cpu'])


def phase_midas_disp(torch, pool, root, fixtures, nets_ck, card, numbers):
    """(c): cli/test_disp on the DIW, KITTI and NYU fixtures on the card
    against the CPU's (test_disp_cpu in the pool, compared when it
    finishes), and eval_diw / eval_dense_depth timed a image on the
    card."""
    import contextlib
    import io
    from instaorder_tpu_torch.cli import test_disp
    from instaorder_tpu_torch.data import readers as R
    from instaorder_tpu_torch.eval import disp as TDISP
    n = {'diw': DIW_IMAGES, 'kitti': KITTI_IMAGES, 'nyu': NYU_IMAGES}
    for name, cname in (('diw', 'DIW/midas_pretrained'),
                        ('kitti', 'kitti/InstaDepthNet_d'),
                        ('nyu', 'kitti/InstaDepthNet_d')):
        ann, img = fixtures[name]
        # NYU has no config of its own: the kitti one, read as NYU's
        path = disp_config_file(root, cname, ann, img, name)
        cfg = disp_config(cname)
        algo = cfg.model['algo']
        ck = nets_ck[cfg.model['backbone_arch']]
        with contextlib.redirect_stdout(io.StringIO()):     # its logs
            res = test_disp.main(['--config', path, '--load_model', ck,
                                  '--device', 'cuda'])
        check(res['n'] == n[name], f'{name}: every image evaluated ({res})')
        fwd = TDISP.make_disp_forward(algo, ck)
        cls = {'diw': R.DIWReader, 'kitti': R.KITTIReader,
               'nyu': R.NYUReader}[name]
        reader = cls(ann, img, cfg.data['data_mean'], cfg.data['data_std'])
        close = 0
        if name == 'diw':
            for i in range(len(reader)):
                orig, chw, (a, b, _), _ = reader[i]
                d = TDISP._upsample_half_pixel_np(
                    TDISP._host(fwd(chw.transpose(1, 2, 0)[None]))[0],
                    orig.shape[0], orig.shape[1])
                da, db = d[a[0], a[1]], d[b[0], b[1]]
                close += abs(da - db) <= DIW_SURE * max(abs(da), abs(db))
            run = lambda: TDISP.eval_diw(fwd, reader, log=lambda *a: None)
        else:
            run = lambda: TDISP.eval_dense_depth(fwd, reader, name,
                                                 log=lambda *a: None)
        with quiet():
            run()                   # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            ms = (time.perf_counter() - t0) * 1e3 / n[name]
        numbers[f'{name} per image'] = ms
        print(f'  cli/test_disp {name}: card {res}; {ms:.3f} ms an image on '
              f'the card (host clock, the eval loop warm; {card})')

        def then(cpu, name=name, res=res, close=close):
            check(cpu['n'] == n[name], f'{name}: every image evaluated on '
                  f'the CPU ({cpu})')
            if name == 'diw':
                if not close:
                    check(res == cpu, f'diw: WHDR equal {res} {cpu}')
                verdict = ('equal' if not close else
                           f'not held ({close} near-tied pairs)')
            else:
                for k, v in cpu.items():
                    check(abs(res[k] - v) <= DENSE_BAR * abs(v),
                          f'{name} {k}: card within {DENSE_BAR} of the CPU '
                          f'({res[k]} vs {v})')
                verdict = f'within {DENSE_BAR}'
            print(f'  cli/test_disp {name}: card {res}, CPU {cpu}: '
                  f'{verdict}')
        pool.later(f'midas test_disp CPU runs: {name}', test_disp_cpu, path,
                   ck, then=then)


def phase_midas(torch, dev, card, wrappers, pool=None):
    """The MiDaS family on the card (module docstring, phase 7); its
    card-vs-CPU comparisons deferred to `pool`'s finish (own_pool; the
    files live in its tempdir until then). Returns {measurement:
    number}."""
    import os
    import numpy as np
    from instaorder_tpu_torch.convert import to_numpy, tree_to
    from instaorder_tpu_torch.core import checkpoint as CK
    from instaorder_tpu_torch.data import readers as R
    from instaorder_tpu_torch.data import synthetic
    from instaorder_tpu_torch.data.image_io import read_rgb
    from instaorder_tpu_torch.models import midas as M
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.ops.resize import resize_nearest

    t0 = time.perf_counter()
    numbers = {}
    for w in wrappers.values():
        w.launches = 0
    with own_pool(pool) as pool:
        root = pool.tempdir()
        insta, img_root = instaorder_fixture(root)
        fixtures = {
            'diw': synthetic.make_diw_fixture(root + '/diw', DIW_IMAGES),
            'kitti': synthetic.make_kitti_fixture(root + '/kitti',
                                                  KITTI_IMAGES),
            'nyu': synthetic.make_nyu_fixture(root + '/nyu', NYU_IMAGES)}
        # the three nets at full width from seed 0, drawn on the CPU
        cpu = {name: get_backbone(name)['init'](
            torch.Generator().manual_seed(0), device='cpu')
            for name in ('MidasNet', 'InstaDepthNet_d', 'InstaDepthNet_od')}
        reader = R.InstaOrderReader(insta)
        modal, _, _, _, fn = reader.get_image_instances(0, with_gt=False)[:5]
        x384 = midas_image(torch, read_rgb(os.path.join(img_root, fn)), dev)
        norm = disp_config('kitti/InstaDepthNet_d').data
        kitti = R.KITTIReader(*fixtures['kitti'], norm['data_mean'],
                              norm['data_std'])
        xk = torch.as_tensor(kitti[0][0].transpose(1, 2, 0)[None],
                             dtype=torch.float32, device=dev)
        mp, ms_, mcfg = cpu['MidasNet']
        check(all(torch.equal(mp['out_conv3']['w'], p['out_conv3']['w'])
                  for p, _, _ in cpu.values()),
              'the three nets share their trunk and decoder (seed 0)')
        before, after, shift = positive_disparity(
            torch, M, tree_to(mp, dev), tree_to(ms_, dev), mcfg, (x384, xk))
        # every variant draws the same trunk and decoder from seed 0: one
        # shift serves the three
        for name, (p, s, cfg) in cpu.items():
            p['out_conv3']['b'] = p['out_conv3']['b'] + shift
        print(f'  positive disparity pixels (the least of 384^2 and '
              f'352x1216): {100 * before:.2f}% at init; out_conv3 bias '
              f'+{shift:.5g} -> {100 * after:.2f}%')
        nets = {name: (tree_to(p, dev), tree_to(s, dev), cfg)
                for name, (p, s, cfg) in cpu.items()}
        pidx = [(0, 1), (0, 2), (1, 2), (2, 3)][:MIDAS_PAIRS]
        mk = torch.as_tensor(modal.astype(np.float32), device=dev)
        mk = resize_nearest(mk, 384, 384)
        pair_masks = (mk[[i for i, _ in pidx]], mk[[j for _, j in pidx]])
        trees = f'{root}/midas_nets.pt'
        torch.save(cpu, trees)
        pool.later('midas CPU forwards', midas_forward_cpu, trees,
                   *(host_tree(x) for x in (x384, xk, *pair_masks)),
                   then=phase_midas_forward(torch, M, nets, x384, xk,
                                            pair_masks, card, numbers, root))
        nets_ck = {name: CK.save_state(f'{root}/{name}', 1, to_numpy(p),
                                       to_numpy(s))
                   for name, (p, s, _) in cpu.items()
                   if name != 'InstaDepthNet_od'}
        del nets, cpu
        phase_midas_tester(pool, dev, root, (insta, img_root), nets_ck, card,
                           numbers)
        phase_midas_disp(torch, pool, root, fixtures, nets_ck, card, numbers)
        torch.cuda.synchronize()
        got = {n: w.launches for n, w in wrappers.items() if w.launches}
        check(not got, f'midas: no kernel launched (JAX\'s MiDaS path '
              f'reaches none): {got}')
        numbers['seconds'] = time.perf_counter() - t0
        print(f'midas phase (the card\'s side): {numbers["seconds"]:.1f} s; '
              f'hand-written kernel launches 0 ({card})')
    return numbers


# ---- PCNet-M (models/unet.py, eval/amodal.py, its Tester method, training) --
# the experiments/<dataset>/pcnet_m configs
PCNET_DATASETS = ('InstaOrder', 'COCOA', 'KINS')
# the Tester's order_th (its getattr default: the test CLI does not set it)
PCNET_TH = 0.1
# the eval nets' xavier gain: at the configs' 0.02 each conv scales its
# input by ~0.02 and the bottleneck's share of the logits is ~1e-25; at
# sqrt(2) every depth reaches the output
PCNET_GAIN = 2 ** 0.5
# the standard deviation of the moved class-1 logit margin over the
# eraser pixels (centre_outc)
PCNET_SPREAD = 2.0
# a pixel's completion is sure when its probability lies more than this
# from the threshold; the card-vs-CPU probability error must stay below
# a tenth of it (checked in (a); measured 4.53e-6 on an H100 at 700 W)
PCNET_SURE = 2e-4
# the InstaOrder fixture's image size here: on phase 5's 480x640 the 6
# rectangles rarely meet (10 of the 240 ordered pairs' patches hold an
# eraser pixel, 3 cells of the ground truth are occlusions), so nearly
# every vote would be 0; at 128x160, 124 and 39
PCNET_HW = (128, 160)
PCNET_CPU_IMAGES = 2        # the Tester images the CPU's are held against
PCNET_XDEV = 4              # patches of the card-vs-CPU SGD step
PCNET_RES_BATCH = 2         # the unet2res forward
# a conv bias that feeds a train-mode BatchNorm: its gradient is 0
PCNET_ZERO_GRAD = ('conv1.b', 'conv2.b', 'reduce_conv.b')
# (run name, dataset, pairs) of the Tester
PCNET_RUNS = [('InstaOrder', 'InstaOrder', 'all'),
              ('InstaOrder nbor', 'InstaOrder', 'nbor'),
              ('COCOA', 'COCOA', 'all'), ('KINS', 'KINS', 'all')]


def pcnet_config(dataset):
    """cli/config.load_config of experiments/<dataset>/pcnet_m/config.yaml
    as the {model, data, trainer} dict that tester_args reads."""
    a = disp_config(f'{dataset}/pcnet_m')
    return {'model': a.model, 'data': a.data, 'trainer': a.trainer}


def pcnet_net(torch, name, gain=PCNET_GAIN, seed=0):
    """(params, stats, cfg) of UNet `name` (in 2, out 2 channels, the
    configs' backbone_param) from seed, on the CPU, at xavier `gain`."""
    from instaorder_tpu_torch.models import unet
    return unet.init(torch.Generator().manual_seed(seed), in_channels=2,
                     n_classes=2, gain=gain, device='cpu',
                     **unet.UNET_FACTORIES[name])


def pair_index(inmodal, pairs):
    """The (t, e) patch order of AmodalCompleter.infer_order: both
    directions of each pair i < j, adjacent (the nbor filter through the
    port's bordering_matrix on the CPU, exact)."""
    import torch
    from instaorder_tpu_torch.ops.morphology import bordering_matrix
    num = inmodal.shape[0]
    if pairs == 'nbor':
        border = bordering_matrix(torch.as_tensor(inmodal)).numpy()
    ind = []
    for i in range(num):
        for j in range(i + 1, num):
            if pairs != 'nbor' or border[i, j]:
                ind += [(i, j), (j, i)]
    return ind


def record_completer(c, log):
    """Wrap an AmodalCompleter (the port's or the JAX package's) so that
    each infer_order call appends a record to `log`: its pair order,
    resize ratios, patches (modal, eraser), the completion
    probabilities, the host ms of the forwards that gave them (the
    patches' batch in and the probabilities out included:
    `forward_ms`) and the order matrix; any other forward (infer_amodal)
    a record of its patches and probabilities."""
    import numpy as np
    raw_order, raw_prob = c.infer_order, c._predict_prob

    def predict_prob(modal_ps, eraser_ps, rgb_ps):
        t0 = time.perf_counter()
        prob = raw_prob(modal_ps, eraser_ps, rgb_ps)
        ms = (time.perf_counter() - t0) * 1e3
        if not log or 'prob' in log[-1]:
            log.append({})
        log[-1].update(modal=np.stack(modal_ps), eraser=np.stack(eraser_ps),
                       prob=np.asarray(prob), forward_ms=ms)
        return prob

    def infer_order(image, inmodal, category, bboxes, pairs='all', *a,
                    input_size=None, **kw):
        ind = pair_index(np.asarray(inmodal, np.uint8), pairs)
        log.append({'num': inmodal.shape[0], 'ind': ind,
                    'ratios': [bboxes[t][2] / float(input_size)
                               for t, _ in ind]})
        out = raw_order(image, inmodal, category, bboxes, pairs, *a,
                        input_size=input_size, **kw)
        log[-1]['order'] = out
        return out
    c._predict_prob = predict_prob
    c.infer_order = infer_order
    return log


def pcnet_sure(rec, th=PCNET_TH, margin=PCNET_SURE):
    """(sure (N, N) bool, {kind: pairs}) of one infer_order record. A
    patch's vote counts its eraser pixels whose completion probability
    exceeds th (the modal is 0 there), times its resize ratio^2; pixels
    within `margin` of th may go either way. A pair is 'empty' when
    neither patch has an eraser pixel (both votes 0 on any device),
    'exact' when neither has a pixel within the margin (both votes are
    the same integers on any device), 'sure' when the two votes'
    intervals (each +- its unsure pixels x ratio^2) do not meet, else
    'unsure' (its two cells are not held)."""
    import numpy as np
    num = rec['num']
    sure = np.ones((num, num), bool)
    kinds = dict.fromkeys(('empty', 'exact', 'sure', 'unsure'), 0)
    votes = []
    for k in range(len(rec['ind'])):
        p = rec['prob'][k][rec['eraser'][k] == 1]
        r2 = rec['ratios'][k] ** 2
        votes.append((p.size, float((p > th).sum()) * r2,
                      float((np.abs(p - th) <= margin).sum()) * r2))
    for k in range(0, len(rec['ind']), 2):
        (n1, v1, u1), (n2, v2, u2) = votes[k], votes[k + 1]
        t, e = rec['ind'][k]
        if n1 == n2 == 0:
            kinds['empty'] += 1
        elif u1 == 0 and u2 == 0:
            kinds['exact'] += 1
        elif abs(v1 - v2) > u1 + u2:
            kinds['sure'] += 1
        else:
            kinds['unsure'] += 1
            sure[t, e] = sure[e, t] = False
    return sure, kinds


def eraser_shares(recs, th=PCNET_TH, margin=PCNET_SURE):
    """(share of the eraser pixels completed, i.e. above th; share within
    margin of th) over infer_order records."""
    import numpy as np
    p = np.concatenate([r['prob'][r['eraser'] == 1] for r in recs
                        if 'prob' in r])
    return float((p > th).mean()), float((np.abs(p - th) <= margin).mean())


def centre_outc(params, d, th=PCNET_TH, spread=PCNET_SPREAD):
    """Move outc of a numpy-or-tensor UNet tree so that the class-1 logit
    margin d (class 1 minus class 0, over the eraser pixels of a forward
    of this net; outc_margins) gets median logit(th) and standard
    deviation `spread`: class 1's column becomes class 0's plus the
    scaled difference. A random UNet's margins are ~0 on every pixel
    (probability ~0.5, above th everywhere: every patch completes to
    all ones and the votes are set by the masks alone)."""
    import numpy as np
    g = spread / max(float(np.std(d)), 1e-30)
    shift = float(np.log(th / (1 - th))) - g * float(np.median(d))
    w, b = params['outc']['w'], params['outc']['b']
    w1 = w[..., 0] + g * (w[..., 1] - w[..., 0])
    b1 = b[0] + g * (b[1] - b[0]) + shift
    out = dict(params)
    if hasattr(w, 'detach'):
        import torch
        out['outc'] = {'w': torch.stack([w[..., 0], w1], -1),
                       'b': torch.stack([b[0], b1])}
    else:
        out['outc'] = {'w': np.stack([w[..., 0], w1], -1).astype(w.dtype),
                       'b': np.stack([b[0], b1]).astype(b.dtype)}
    return out


def outc_margins(logits, eraser):
    """The class-1 logit margins (class 1 minus class 0) of NHWC logits at
    the eraser pixels, float64 numpy."""
    import numpy as np
    lg = _host(logits).astype(np.float64)
    return (lg[..., 1] - lg[..., 0])[np.asarray(eraser) == 1]


def compare_pcnet_runs(name, got, want):
    """The card's first Tester images against the CPU's: ground truth
    equal, the same pairs, matrices equal at every sure cell
    (pcnet_sure of the CPU's record). Returns ({pair kind: count},
    differing cells)."""
    import collections
    import numpy as np
    check(len(want) == PCNET_CPU_IMAGES and len(got) >= len(want),
          f'{name}: {len(got)} card images against {len(want)}')
    n = collections.Counter()
    differ = 0
    for k, (g, w) in enumerate(zip(got, want)):
        check(np.array_equal(g['gt_occlusion'], w['gt_occlusion']),
              f'{name} image {k}: gt equal')
        gp, wp = g['pcnet'], w['pcnet']
        check(gp['ind'] == wp['ind'] and np.array_equal(gp['modal'],
                                                         wp['modal'])
              and np.array_equal(gp['eraser'], wp['eraser']),
              f'{name} image {k}: the same patches')
        sure, kinds = pcnet_sure(wp)
        a, b = np.asarray(g['occ']), np.asarray(w['occ'])
        check((a == b)[sure].all(), f'{name} image {k}: matrices equal at '
              f'every sure cell ({int((a != b)[sure].sum())} differ)')
        n.update(kinds)
        differ += int((a != b).sum())
    return dict(n), differ


def first_occ_metrics(recs, n):
    """The Tester's occlusion metrics over its first n images' records (as
    its eval_occ_order gives them on n images)."""
    import numpy as np
    from instaorder_tpu_torch.eval.metrics import \
        eval_order_recall_precision_f1
    rpf = np.array([eval_order_recall_precision_f1(r['occ'],
                                                   r['gt_occlusion'], 0)
                    for r in recs[:n]])
    return {'recall': float(np.mean(rpf[:, 0])),
            'precision': float(np.mean(rpf[:, 1])),
            'f1': float(np.mean(rpf[:, 2])), 'n': n}


def record_pcnet_tester(t):
    """record_tester(t), and each image's completer record (pair order,
    patches, probabilities) under 'pcnet'."""
    log = record_tester(t)
    prepare = t.prepare_model

    def prepare_model():
        prepare()
        comp = []
        record_completer(t.completer, comp)
        raw = t.completer.infer_order

        def infer_order(*a, **kw):
            out = raw(*a, **kw)
            log[-1]['pcnet'] = comp[-1]
            return out
        t.completer.infer_order = infer_order
    t.prepare_model = prepare_model
    return log


def pool_recorder(torch, indices, flips=None, ties=None):
    """A core/nn.max_pool of NHWC x (its window, stride and padding: the
    UNet's 2x2 / 2, the ResNet stems' 3x3 / 2) that records each window's
    argmax (torch's flat H*W index, in call order) into `indices` (and
    into ties[0], when given, the windows whose maximum is not unique);
    with flips given, one that follows `indices` instead and counts in
    flips[0] the windows whose own argmax differs, in flips[1] those of
    them whose two candidates differ in value (not an exact tie), in
    flips[2] those whose values differ by more than 1e-5 of the maximum
    (not a near-tie either: a tie's flip keeps the value and moves only
    the gradient)."""
    import torch.nn.functional as F
    it = iter(indices)

    def pool(x, window=2, stride=2, padding=0):
        xc = x.permute(0, 3, 1, 2)
        y, idx = F.max_pool2d(xc, window, stride, padding,
                              return_indices=True)
        if flips is None:
            indices.append(idx.detach().cpu())
            if ties is not None:
                n, c, ho, wo = y.shape
                win = F.unfold(F.pad(xc.detach(), (padding,) * 4,
                                     value=float('-inf')), window,
                               stride=stride).view(n, c, window * window, -1)
                hits = (win == y.detach().reshape(n, c, 1, -1)).sum(2)
                ties[0] += int((hits > 1).sum())
            return y.permute(0, 2, 3, 1)
        want = next(it).to(x.device)
        n, c, ho, wo = want.shape
        plane = xc.reshape(n, c, -1)
        out = torch.gather(plane, 2, want.reshape(n, c, -1)).reshape(
            n, c, ho, wo)
        moved = idx != want
        gap = (y - out).detach().abs()
        flips[0] += int(moved.sum())
        flips[1] += int((moved & (gap > 0)).sum())
        flips[2] += int((moved & (gap > 1e-5 * y.detach().abs())).sum())
        return out.permute(0, 2, 3, 1)
    return pool


def pcnet_fixtures(root):
    """Phase 8's fixtures under root: InstaOrder at PCNET_HW, COCOA, KINS;
    {dataset: (annotation file, image root)}."""
    from instaorder_tpu_torch.data import synthetic
    return {'InstaOrder': instaorder_fixture(root, PCNET_HW),
            'COCOA': synthetic.make_cocoa_fixture(root),
            'KINS': synthetic.make_kins_fixture(root)}


def pcnet_cpu():
    """Reference job of phases 8 and 11 (the CPU side of each card-vs-CPU
    check there), on phase 8's fixtures: (a) unet2 from seed 0 with its
    outc moved on the first image's patches (centre_outc, from the CPU
    forward) and its CPU logits, the unet2res CPU logits on their first
    PCNET_RES_BATCH patches; (b) the CPU Tester runs (the first
    PCNET_CPU_IMAGES images) on the moved net's checkpoint; (d) the CPU's
    f64 and f32 SGD steps; phase 11 (a)'s CPU instseg. numpy."""
    import tempfile
    import numpy as np
    import torch
    from instaorder_tpu_torch import convert as CV
    from instaorder_tpu_torch.data import readers as R
    from instaorder_tpu_torch.data.image_io import read_rgb
    from instaorder_tpu_torch.eval import amodal as AM
    from instaorder_tpu_torch.eval.tester import expand_bbox
    from instaorder_tpu_torch.models import unet as U
    from instaorder_tpu_torch.ops.resize import resize_cubic_u8
    from instaorder_tpu_torch.utils.geometry import crop_padding
    out = {}
    with tempfile.TemporaryDirectory() as root:
        fixtures = pcnet_fixtures(root)
        insta, img_root = fixtures['InstaOrder']
        modal, cat, bboxes, _, fn = R.InstaOrderReader(insta).\
            get_image_instances(0, with_gt=False)[:5]
        image = read_rgb(os.path.join(img_root, fn))
        ebb = expand_bbox(bboxes)
        size = pcnet_config('InstaOrder')['data']['input_size']
        p, s, cfg = pcnet_net(torch, 'unet2')
        log = []
        cpu = AM.AmodalCompleter(U.apply, cfg, p, s, device='cpu')
        record_completer(cpu, log)
        cpu.infer_order(image, modal.astype(np.uint8), cat, ebb,
                        th=PCNET_TH, input_size=size)
        x = torch.from_numpy(np.stack([log[0]['modal'], log[0]['eraser']],
                                      -1).astype(np.float32))
        with torch.no_grad():
            d = outc_margins(U.apply(p, s, cfg, x), log[0]['eraser'])
            p = centre_outc(p, d)
            want = U.apply(p, s, cfg, x)
        rp, rs, rcfg = pcnet_net(torch, 'unet2res')
        rgb = torch.from_numpy(np.stack([
            resize_cubic_u8(crop_padding(image, ebb[t], (0, 0, 0)), size,
                            size)
            for t, _ in log[0]['ind'][:PCNET_RES_BATCH]]).astype(np.float32))
        with torch.no_grad():
            want_res = U.apply(rp, rs, rcfg, x[:PCNET_RES_BATCH], rgb=rgb)
        out['forward'] = host_tree(dict(
            p=p, s=s, cfg=cfg, x=x, eraser=log[0]['eraser'], margins=d,
            want=want, res=(rp, rs, rcfg, rgb, want_res)))
        net = (CV.to_numpy(p), CV.to_numpy(s), cfg)
        out['tester'] = pcnet_tester_cpu(root, fixtures, net)
        out['xdev'] = pcnet_xdev_cpu(fixtures['InstaOrder'])
        out['instseg'] = instseg_cpu(net, fixtures['InstaOrder'])
    return out


def phase_pcnet_forward(torch, dev, card, numbers, ref):
    """(a): unet2 at full width from seed 0 (PCNET_GAIN), its outc moved
    on the InstaOrder fixture's first image (centre_outc); its logits on
    that image's 256^2 patches card vs CPU; a unet2res forward at batch
    PCNET_RES_BATCH. ref: pcnet_cpu's 'forward'. Returns the moved
    (params, stats, cfg), numpy."""
    import numpy as np
    from instaorder_tpu_torch.convert import to_numpy, tree_to
    from instaorder_tpu_torch.core.nn import param_count
    from instaorder_tpu_torch.models import unet as U
    size = pcnet_config('InstaOrder')['data']['input_size']
    ref = torch_tree(torch, ref)
    p, s, cfg, x, d, want = (ref[k] for k in ('p', 's', 'cfg', 'x',
                                               'margins', 'want'))
    eraser, d = ref['eraser'].numpy(), d.numpy()
    n_pix = int((eraser == 1).sum())
    check(n_pix > 0, 'pcnet: the first image\'s patches hold eraser pixels')
    with torch.no_grad():
        got = U.apply(tree_to(p, dev), tree_to(s, dev), cfg, x.to(dev))
        torch.cuda.synchronize()
        err = worst_rel(got, want)
        perr = float((torch.softmax(got, -1)[..., 1].cpu() -
                      torch.softmax(want, -1)[..., 1]).abs().max())
    check(err <= MIDAS_BAR, f'pcnet unet2 logits card vs CPU within '
          f'{MIDAS_BAR} of max |CPU| ({err:.3e})')
    check(perr <= PCNET_SURE / 10, f'pcnet: the card-vs-CPU probability '
          f'error {perr:.3e} within a tenth of the sure margin {PCNET_SURE}')
    prob = torch.softmax(want, -1)[..., 1].numpy()
    above, near = eraser_shares([{'prob': prob, 'eraser': eraser}])
    check(0.05 < above < 0.95, f'pcnet: a real share of the eraser pixels '
          f'on each side of th ({above:.3f} above)')
    print(f'  pcnet unet2 ({param_count(p)} params, '
          f'{x.shape[0]} patches of {size}^2): card vs CPU logits '
          f'{err:.3e} of max |CPU|, probabilities {perr:.3e}; outc moved '
          f'(margin median {np.median(d):.4g}, std {np.std(d):.4g} -> '
          f'logit({PCNET_TH}), {PCNET_SPREAD}); of {n_pix} eraser pixels '
          f'{100 * above:.2f}% above th {PCNET_TH}, {100 * near:.4f}% '
          f'within {PCNET_SURE} of it')
    numbers['forward err'] = err
    numbers['prob err'] = perr
    # the *res variant: the RGB patches as the completer feeds them
    rp, rs, rcfg, rgb, want = ref['res']
    k = PCNET_RES_BATCH
    with torch.no_grad():
        got = U.apply(tree_to(rp, dev), tree_to(rs, dev), rcfg,
                      x[:k].to(dev), rgb=rgb.to(dev))
    err = worst_rel(got, want)
    check(err <= MIDAS_BAR, f'pcnet unet2res logits card vs CPU within '
          f'{MIDAS_BAR} ({err:.3e})')
    print(f'  pcnet unet2res ({k} patches of {size}^2 and their RGB): card '
          f'vs CPU logits {err:.3e} of max |CPU|')
    return to_numpy(p), to_numpy(s), cfg


def quiet_tester_log(name):
    """A logger that drops a Tester's lines."""
    import logging
    log = logging.getLogger(name)
    log.addHandler(logging.NullHandler())
    log.propagate = False
    return log


def pcnet_tester_cpu(root, fixtures, net):
    """Phase 8 (b)'s CPU side: each PCNET_RUNS Tester run on the CPU over
    the first PCNET_CPU_IMAGES images, the net saved (step 7) and loaded
    through load_model; {run: (records, result)}."""
    from instaorder_tpu_torch.core import checkpoint as CK
    from instaorder_tpu_torch.eval.tester import Tester
    ck = CK.save_state(f'{root}/pcnet', 7, net[0], net[1])
    out = {}
    for name, dataset, pairs in PCNET_RUNS:
        args = tester_args(pcnet_config(dataset), root, fixtures, '', pairs,
                           ck)
        t = Tester(args, logger=quiet_tester_log('chip_smoke.pcnet'),
                   device='cpu', n_images=PCNET_CPU_IMAGES)
        recs = record_pcnet_tester(t)
        res = t.run()
        check(t.order_method == 'PartialCompletionMask' and
              t.completer.device.type == 'cpu' and t.curr_step == 7,
              f'pcnet tester {name}: the completer on the CPU, step 7')
        out[name] = (recs, res)
    return out


def phase_pcnet_tester(torch, root, fixtures, net, dev, card, numbers, ref):
    """(b): Tester.run() with the PartialCompletionMask method on the card
    (every fixture image) against the CPU's (the first PCNET_CPU_IMAGES;
    ref: pcnet_tester_cpu's), the net saved with the port's save_state and
    loaded through load_model."""
    import numpy as np
    from instaorder_tpu_torch.core import checkpoint as CK
    from instaorder_tpu_torch.eval.tester import Tester
    log = quiet_tester_log('chip_smoke.pcnet')
    ck = CK.save_state(f'{root}/pcnet', 7, net[0], net[1])
    for name, dataset, pairs in PCNET_RUNS:
        cfg = pcnet_config(dataset)
        args = tester_args(cfg, root, fixtures, '', pairs, ck)
        t = Tester(args, logger=log, device=None, n_images=-1)
        recs, res = {'card': record_pcnet_tester(t)}, {}
        with quiet():
            res['card'] = t.run()
        check(t.order_method == 'PartialCompletionMask' and
              t.completer.device.type == dev.type and t.curr_step == 7,
              f'pcnet tester {name}: the completer on card, step 7')
        recs['cpu'], res['cpu'] = ref[name]
        kinds, differ = compare_pcnet_runs(name, recs['card'], recs['cpu'])
        first = first_occ_metrics(recs['card'], PCNET_CPU_IMAGES)
        if not differ:
            check(first == res['cpu'], f'pcnet tester {name}: metrics on the '
                  f'first {PCNET_CPU_IMAGES} images equal ({first} vs '
                  f'{res["cpu"]})')
        check(all(np.isfinite(v) for v in res['card'].values()),
              f'pcnet tester {name}: finite metrics')
        above, near = eraser_shares([r['pcnet'] for r in recs['card']])
        med = lambda k: float(np.median([r[k] for r in  # noqa: E731
                                         recs['card'][1:]]))
        fwd = float(np.median([r['pcnet']['forward_ms']
                               for r in recs['card'][1:]]))
        numbers[f'tester {name}'] = (med('ms'), med('predict_ms'), fwd)
        print(f'  pcnet tester {name}: {res["card"]}; card vs CPU (first '
              f'{PCNET_CPU_IMAGES} images): pairs {kinds}, {differ} cells '
              f'differ; metrics '
              f'{"equal" if not differ else "not held"}; eraser pixels '
              f'{100 * above:.2f}% above th, {100 * near:.4f}% within '
              f'{PCNET_SURE}; per image {med("ms"):.3f} ms, '
              f'{med("predict_ms"):.3f} of it the prediction, {fwd:.3f} of '
              f'that the forwards with the patches in and the probabilities '
              f'out (host clock, median after one warm-up image; {card})')


def phase_pcnet_train(torch, root, fixtures):
    """(c): the InstaOrder config's full flow (train_flow); COCOA and KINS
    3 steps each (three_steps)."""
    from instaorder_tpu_torch.train import trainer as T
    train_flow(torch, T, 'pcnet_m', fixtures['InstaOrder'], f'{root}/p',
               pcnet_config('InstaOrder'))
    for dataset in ('COCOA', 'KINS'):
        three_steps(torch, T, 'pcnet_m', fixtures[dataset],
                    f'{root}/p_{dataset}', dataset)


def pcnet_xdev_cpu(fixture):
    """Phase 8 (d)'s CPU side: the InstaOrder config's net at full width
    (seed 0) and PCNET_XDEV patches of the port's dataset; the CPU's f64
    step (recording the ReLU branch and the pool argmaxes) and its f32
    step on that branch. numpy."""
    import torch
    from instaorder_tpu_torch import convert as CV
    from instaorder_tpu_torch.data.datasets import DATASETS, collate
    from instaorder_tpu_torch.data.loader import sample_rng
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.train import step as ST
    from instaorder_tpu_torch.train import trainer as T
    cpu = torch.device('cpu')
    args = train_args('pcnet_m', fixture, 1)
    net = get_backbone(args.model['backbone_arch'])
    params, stats, cfg = net['init'](torch.Generator().manual_seed(0),
                                     device='cpu',
                                     **args.model['backbone_param'])
    params, stats = CV.to_numpy(params), CV.to_numpy(stats)
    ds = DATASETS[args.data['trainval_dataset']](args.data, 'train',
                                                 args.model['algo'])
    batch = collate([ds.sample(i % len(ds), sample_rng(0, i))
                     for i in range(PCNET_XDEV)])
    run = lambda branch=None, dtype=None: train_step_on(  # noqa: E731
        torch, T, ST, CV, net, cfg, args.model, params, stats, batch, cpu,
        branch, dtype)
    l64, p64, s64, branch, _, _ = run(None, torch.float64)
    l32, p32, s32, _, _, _ = run(branch)
    return dict(params=params, stats=stats, cfg=cfg, batch=batch,
                f64=(l64, p64, s64), f32=(l32, p32, s32),
                branch=host_tree(branch))


def phase_pcnet_xdev(torch, fixture, dev, card, numbers, ref):
    """(d): one SGD step of the InstaOrder config at full width on
    PCNET_XDEV patches of the port's dataset on the card against the
    CPU's f64 and f32 steps (ref: pcnet_xdev_cpu's), every run on the CPU
    f64 run's ReLU branch and pool argmaxes, the card's flips counted;
    the card's step against the CPU's f64 one."""
    import numpy as np
    from instaorder_tpu_torch import convert as CV
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.train import step as ST
    from instaorder_tpu_torch.train import trainer as T
    args = train_args('pcnet_m', fixture, 1)
    params, stats, cfg, batch = (ref[k] for k in ('params', 'stats', 'cfg',
                                                  'batch'))
    l64, p64, s64 = ref['f64']
    l32, p32, s32 = ref['f32']
    branch = torch_tree(torch, ref['branch'])
    lg, pg, sg, _, flips, _ = train_step_on(
        torch, T, ST, CV, get_backbone(args.model['backbone_arch']), cfg,
        args.model, params, stats, batch, dev, branch)
    out = {}
    for who, (l, p, s) in (('card f32', (lg, pg, sg)),
                           ('CPU f32', (l32, p32, s32))):
        out[who] = (abs(l - l64) / abs(l64),
                    leaf_worst(p, p64, params, 'params', PCNET_ZERO_GRAD),
                    leaf_worst(s, s64, None, 'stats'))
        lrel, upd, sts = out[who]
        print(f'  pcnet one SGD step ({PCNET_XDEV} patches, '
              f'{args.data["input_size"]}^2; {card}): {who} vs CPU f64: loss '
              f'{l:.6f} vs {l64:.6f} (rel {lrel:.3e}); worst update '
              f'{upd[1]} {upd[0]:.3e} of its max |update|; worst stats '
              f'{sts[1]} {sts[0]:.3e}')
    n_relu = sum(int(m.numel()) for m in branch[0])
    n_pool = sum(int(i.numel()) for i in branch[1])
    print(f'  pcnet step: {flips[0]} of {n_relu} ReLU inputs on the other '
          f'side of zero on the card; of {n_pool} pool windows '
          f'{branch[2][0]} tied on the CPU (the maximum not unique), '
          f'{flips[1]} with another argmax on the card, {flips[2]} of them '
          f'not exact ties, {flips[3]} beyond 1e-5 of the max (every run '
          f'follows the CPU f64 run\'s branch and argmaxes)')
    numbers['xdev'] = out['card f32']
    numbers['flips'] = flips
    numbers['pool ties'] = branch[2][0]
    lrel, upd, sts = out['card f32']
    check(np.isfinite(lg) and lrel <= XDEV_LOSS_BAR,
          f'pcnet: card loss within {XDEV_LOSS_BAR} of the CPU\'s f64')
    check(upd[0] <= XDEV_UPDATE_BAR,
          f'pcnet: every update within {XDEV_UPDATE_BAR} ({upd})')
    check_stats('pcnet', sg, s32, s64, card)


# phases 8 and 11's reference job: (pool label, job)
PCNET_REFS = ('pcnet + instseg CPU references', pcnet_cpu)


def phase_pcnet(torch, dev, card, wrappers, pool=None):
    """PCNet-M on the card (module docstring, phase 8), its CPU
    references from `pool` (own_pool; pcnet_cpu, phase 11's instseg
    included: returned under 'instseg'). Returns {measurement:
    number}."""
    import tempfile
    from instaorder_tpu_torch.train import trainer as T

    t0 = time.perf_counter()
    numbers = {}
    for w in wrappers.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as root, own_pool(pool) as pool:
        fixtures = pcnet_fixtures(root)
        ref = pool.result(*PCNET_REFS)
        net = phase_pcnet_forward(torch, dev, card, numbers, ref['forward'])
        numbers['net'] = net
        numbers['instseg'] = ref['instseg']
        phase_pcnet_tester(torch, root, fixtures, net, dev, card, numbers,
                           ref['tester'])
        phase_pcnet_train(torch, root, fixtures)
        phase_pcnet_xdev(torch, fixtures['InstaOrder'], dev, card, numbers,
                         ref['xdev'])
        # the step on a fixed batch and the loader-fed window
        bt, dt, alone, ta, batch = time_loader_fed(
            T, 'pcnet_m', fixtures['InstaOrder'], f'{root}/w')
        ms, peak = time_train_step(torch, T, ta, batch)
        n, d = ta.args.data['batch_size'], ta.args.data
        numbers.update(step_ms=ms, peak_gib=peak, batch_ms=bt, data_ms=dt,
                       alone_ms=alone)
        print(f'  pcnet train {ta.args.model["backbone_arch"]} '
              f'{d["input_size"]}^2 batch {n}: device step {ms:.2f} ms '
              f'(median of {TIMING_REPS} after {TIMING_WARMUP}, fixed batch '
              f'on the card) = {n / ms * 1e3:.1f} patches/s, peak memory '
              f'{peak:.2f} GiB; {ta.args.data["workers"]} thread workers: '
              f'Trainer loader-fed batch time {bt:.2f} ms = '
              f'{n / bt * 1e3:.1f} patches/s, data time {dt:.2f} ms (steps '
              f'{LOADER_WARMUP + 1}-{LOADER_WARMUP + LOADER_WINDOW}); the '
              f'loader alone {alone:.2f} ms a batch ({card})')
        del ta
    torch.cuda.synchronize()
    got = {n: w.launches for n, w in wrappers.items() if w.launches}
    check(not got, f'pcnet: no kernel launched (JAX\'s PCNet-M path reaches '
          f'none): {got}')
    numbers['seconds'] = time.perf_counter() - t0
    print(f'pcnet phase: {numbers["seconds"]:.1f} s; hand-written kernel '
          f'launches 0 ({card})')
    return numbers


# ---- the last modules (eval/amodal instseg / hull, Mapillary, models/legacy,
# utils/profiling) ------------------------------------------------------------
# the Mapillary fixture of the PCNet-M Trainer: images, instances a map,
# and its size
MAPILLARY_FIXTURE = dict(n_images=8, n_instances=5, h=192, w=256)
# the legacy nets at the reference's widths: PConvUNet's layer_size and
# input side, the batch of every forward, the AE / VAE / discriminator /
# VGG16 input side, the discriminators' input channels, and the side of
# the inpainting-loss gradient (PConvUNet + VGG16 on the CPU in f64 at
# 512^2 would take minutes)
LEGACY_PCONV = (7, 512)
LEGACY_BATCH = 2
LEGACY_SIDE = 256
LEGACY_DISC_IN = {'inpaint': 4, 'nlayer': 3}
LEGACY_GRAD_SIDE = 256
# card forward timing: StepTimer's mean over this many after a warm-up
LEGACY_WARMUP, LEGACY_REPS = 2, 10
# the card's f32 run of a net with BatchNorm, in train mode (its forward,
# statistics and inpainting_loss's gradient), against the CPU's f64:
# within this many times the CPU f32 run's own distance from f64 (where
# above the phase's bar); every other legacy run within XDEV_CPU_FACTOR
# times. The AE's 14 train-mode BatchNorms amplify any change of the f32
# sum order: its train forward lies 1.94e-5 from f64 on an H100 (700 W),
# 1.56e-5 with cuDNN switched off, against the CPU f32 run's 8.0e-6;
# legacy_xdev prints the cuDNN-off forward beside the card's.
LEGACY_CPU_FACTOR = 4
# the legacy nets with BatchNorm
LEGACY_BN = ('PConvUNet', 'AE256', 'VAE32')
# the card's f64 run against the CPU's f64 (the same function, other sums):
# train-mode forwards and the gradient (eval-mode BatchNorm computes in
# f32 whatever its input: the AE256's eval "f64" runs lie 5.3e-7 apart)
LEGACY_F64_BAR = 1e-9


def legacy_nets(torch):
    """{name: (apply(trees, inputs, train) -> (out, new_stats), trees,
    inputs)} of the legacy nets at the reference's widths, from seed 0 on
    the CPU (numpy-seeded inputs; the VAE's noise fed in)."""
    import numpy as np
    from instaorder_tpu_torch.models import legacy as L
    rng = np.random.RandomState(0)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    n, side = LEGACY_BATCH, LEGACY_SIDE
    nets = {}
    ls, pside = LEGACY_PCONV
    p, st, cfg = L.pconv_unet_init(gen, layer_size=ls)
    mask = torch.from_numpy((rng.rand(1, pside, pside, 1) > 0.3).astype(
        np.float32)).expand(1, pside, pside, 3).contiguous()
    nets[f'PConvUNet layer_size={ls} {pside}^2'] = (
        (lambda cfg: lambda tr, x, train: L.pconv_unet_apply(
            tr[0], tr[1], cfg, x[0], x[1], train=train))(cfg),
        (p, st), (t(1, pside, pside, 3), mask))
    for name, kw in L.AE_FACTORIES.items():
        if name == 'AE32':
            continue
        p, st, cfg = L.ae_init(gen, **kw)
        eps = t(n, kw['latent_dim'])
        nets[f'{name} {side}^2'] = (
            (lambda cfg, eps: lambda tr, x, train: L.ae_apply(
                tr[0], tr[1], cfg, x[0], train=train,
                eps=eps.to(x[0]) if train else None))(cfg, eps),
            (p, st), (t(n, side, side, 3),))
    for kind, cin in LEGACY_DISC_IN.items():
        init = getattr(L, f'{kind}_discriminator_init')
        apply = getattr(L, f'{kind}_discriminator_apply')
        p, st, cfg = init(gen, cin)
        nets[f'{kind} discriminator {side}^2'] = (
            (lambda apply, cfg: lambda tr, x, train: apply(
                tr[0], tr[1], cfg, x[0], train=train))(apply, cfg),
            (p, st), (t(n, side, side, cin),))
    vp, vcfg = L.vgg16_extractor_init(gen)
    nets[f'VGG16 extractor {side}^2'] = (
        (lambda vcfg: lambda tr, x, train: (L.vgg16_extractor_apply(
            tr[0], vcfg, x[0]), {}))(vcfg),
        (vp, {}), (t(n, side, side, 3),))
    return nets


def _cast_to(torch, tree, dtype, device):
    from instaorder_tpu_torch.convert import tree_to
    from instaorder_tpu_torch.core.nn import tree_cast
    return tree_to(tree_cast(tree, dtype), device)


def _out_leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _out_leaves(o)]
    return [out]


LEGACY_CPU_RUNS = (('f64', 'float64'), ('f32', 'float32'))


def legacy_cpu():
    """Phase 11 (c)'s CPU side: each legacy net's eval and train forwards
    on the CPU in f64 and f32 ({(name, train): {who: (outputs as f64,
    new statistics)}}), and inpainting_loss's gradient in f64 and f32
    ({who: (loss, {leaf: gradient})}). numpy."""
    import torch
    from instaorder_tpu_torch.convert import to_numpy
    out = {}
    for name, (apply, trees, inputs) in legacy_nets(torch).items():
        for train in (False, True):
            runs = out[name, train] = {}
            for who, dt in LEGACY_CPU_RUNS:
                dt = getattr(torch, dt)
                tr = [_cast_to(torch, x, dt, 'cpu') for x in trees]
                xs = [x.to(dt) for x in inputs]
                with torch.no_grad():
                    o, st = apply(tr, xs, train)
                runs[who] = ([v.double().numpy() for v in _out_leaves(o)],
                             to_numpy(st))
    p, st, cfg, vgg, vcfg, x, m, gt = legacy_grad_inputs(torch)
    grads = {who: inpaint_grad(torch, p, st, cfg, vgg, vcfg, x, m, gt,
                               getattr(torch, dt), 'cpu')
             for who, dt in LEGACY_CPU_RUNS}
    return out, {who: (loss, host_tree(g)) for who, (loss, g)
                 in grads.items()}


# phase 11's reference job: (pool label, job)
LEGACY_REFS = ('legacy CPU f64 + f32 runs and gradients', legacy_cpu)


def legacy_xdev(torch, name, apply, trees, inputs, dev, card, numbers,
                ref):
    """Eval and train forwards of one legacy net on the card against the
    CPU's f64 run (ref: legacy_cpu's for this net): the card's f64 run
    within LEGACY_F64_BAR of max |f64| (train mode), its f32 run within
    max(MIDAS_BAR, factor x the CPU f32 run's own distance from f64), the
    train mode's new statistics by check_stats at that factor; factor
    LEGACY_CPU_FACTOR for a train-mode net with BatchNorm (LEGACY_BN),
    whose card f32 forward is also run and printed with cuDNN switched
    off, else XDEV_CPU_FACTOR. The card's eval forward timed with
    StepTimer."""
    from instaorder_tpu_torch.convert import to_numpy
    from instaorder_tpu_torch.utils.profiling import StepTimer
    for train in (False, True):
        bn = train and name.split()[0] in LEGACY_BN
        factor = LEGACY_CPU_FACTOR if bn else XDEV_CPU_FACTOR
        runs = {who: ([torch.from_numpy(v) for v in outs], st)
                for who, (outs, st) in ref[name, train].items()}
        for who, dt in (('card f64', torch.float64),
                        ('card', torch.float32),
                        *((('card no cuDNN', torch.float32),) if bn
                          else ())):
            tr = [_cast_to(torch, x, dt, dev) for x in trees]
            xs = [x.to(dt).to(dev) for x in inputs]
            with torch.no_grad(), torch.backends.cudnn.flags(
                    enabled=who != 'card no cuDNN', allow_tf32=False):
                out, st = apply(tr, xs, train)
            runs[who] = ([o.double().cpu() for o in _out_leaves(out)],
                         to_numpy(st))
        mode = 'train' if train else 'eval'
        if bn:
            nocudnn = max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(runs['card no cuDNN'][0],
                                          runs['f64'][0]))
            cpu32 = max(float((c - w).abs().max() / w.abs().max())
                        for c, w in zip(runs['f32'][0], runs['f64'][0]))
            numbers[name, 'no cuDNN'] = nocudnn
            print(f'  legacy {name} {mode}: the card f32 with cuDNN '
                  f'switched off {nocudnn:.3e} from the CPU f64 (the CPU '
                  f'f32 {cpu32:.3e})')
        worst, bar_w, worst64 = 0.0, MIDAS_BAR, 0.0
        for g, g64, c, w in zip(*(runs[k][0] for k in (
                'card', 'card f64', 'f32', 'f64'))):
            scale = float(w.abs().max())
            e64 = float((g64 - w).abs().max()) / scale
            # eval-mode BatchNorm computes in f32 whatever its input
            # (core/nn.batch_norm_eval): only train mode is f64 throughout
            check(e64 <= LEGACY_F64_BAR or not train, f'{name} {mode}: the '
                  f'card\'s f64 run within {LEGACY_F64_BAR} of the CPU\'s '
                  f'({e64:.3e})')
            worst64 = max(worst64, e64)
            e_card = float((g - w).abs().max()) / scale
            bar = max(MIDAS_BAR, factor * float((c - w).abs().max())
                      / scale)
            check(e_card <= bar, f'{name} {mode}: card within {bar:.3e} of '
                  f'the CPU f64 ({e_card:.3e})')
            if e_card / bar > worst / bar_w:
                worst, bar_w = e_card, bar
        print(f'  legacy {name} {mode}: card vs CPU f64 outputs worst '
              f'{worst:.3e} (bar {bar_w:.3e}), the card\'s f64 run '
              f'{worst64:.3e}, over {len(runs["card"][0])} outputs')
        numbers[name, mode] = worst
        if train and runs['f64'][1]:
            check_stats(f'legacy {name}', *(runs[k][1] for k in (
                'card', 'f32', 'f64')), card, factor=factor)
    tr = [_cast_to(torch, x, torch.float32, dev) for x in trees]
    xs = [x.to(dev) for x in inputs]
    timer = StepTimer(window=LEGACY_REPS)
    with torch.no_grad(), quiet():
        for k in range(LEGACY_WARMUP + LEGACY_REPS):
            timer.start()
            timer.stop(apply(tr, xs, False)[0])
    numbers[name, 'ms'] = timer.avg * 1e3
    print(f'  legacy {name}: eval forward {timer.avg * 1e3:.3f} ms '
          f'(StepTimer, mean of {LEGACY_REPS} after {LEGACY_WARMUP}; '
          f'{card})')
    return tr, xs


def inpaint_grad(torch, params, stats, cfg, vgg, vcfg, x, m, gt, dt, d):
    """(loss, {leaf path: gradient} as float64 CPU tensors) of the sum of
    inpainting_loss through a train-mode PConvUNet and the VGG16
    extractor, in dtype dt on device d."""
    from instaorder_tpu_torch import losses as TL
    from instaorder_tpu_torch.models import legacy as L
    p = _cast_to(torch, params, dt, d)
    paths, leaves = [], []
    for k, blk in p.items():
        for kk, v in blk.items():
            for kkk, t in (v.items() if isinstance(v, dict) else ()):
                t.requires_grad_(True)
                paths.append(f'{k}.{kk}.{kkk}')
                leaves.append(t)
    vg = _cast_to(torch, vgg, dt, d)
    x, m, gt = (a.to(dt).to(d) for a in (x, m, gt))
    (out, _), _ = L.pconv_unet_apply(p, _cast_to(torch, stats, dt, d), cfg,
                                     x, m, train=True)
    terms = TL.inpainting_loss(
        x, m, out, gt, extractor=lambda im: L.vgg16_extractor_apply(
            vg, vcfg, im))
    loss = sum(terms.values())
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {k: g.double().cpu()
                                  for k, g in zip(paths, grads)}


def legacy_grad_inputs(torch):
    """The inpainting gradient's inputs from seed 1: (PConvUNet params,
    stats, cfg (layer_size LEGACY_PCONV[0]), VGG16 params, cfg, image,
    mask, ground truth at LEGACY_GRAD_SIDE^2)."""
    import numpy as np
    from instaorder_tpu_torch.models import legacy as L
    gen = torch.Generator().manual_seed(1)
    p, st, cfg = L.pconv_unet_init(gen, layer_size=LEGACY_PCONV[0])
    vgg, vcfg = L.vgg16_extractor_init(gen)
    rng = np.random.RandomState(1)
    side = LEGACY_GRAD_SIDE
    x, gt = (torch.from_numpy(rng.randn(1, side, side, 3).astype(
        np.float32)) for _ in range(2))
    m = torch.from_numpy((rng.rand(1, side, side, 1) > 0.3).astype(
        np.float32)).expand(1, side, side, 3).contiguous()
    return p, st, cfg, vgg, vcfg, x, m, gt


def legacy_grad_xdev(torch, dev, card, numbers, ref):
    """inpainting_loss's gradient through PConvUNet (layer_size 7, train
    mode) and VGG16 at LEGACY_GRAD_SIDE^2, card against the CPU's f64 (ref:
    legacy_cpu's): the card's f64 gradient within LEGACY_F64_BAR of each
    leaf's max; in f32 the loss within XDEV_LOSS_BAR relative, each leaf
    within max(XDEV_UPDATE_BAR, LEGACY_CPU_FACTOR x the CPU f32 run's own
    error) of its max |f64 gradient| (the partial convolutions divide by
    the window's mask count, so the deep leaves' gradients are small
    differences of large terms; tests/test_torch_legacy.py)."""
    import numpy as np
    p, st, cfg, vgg, vcfg, x, m, gt = legacy_grad_inputs(torch)
    side = LEGACY_GRAD_SIDE
    runs = {who: (loss, torch_tree(torch, g)) for who, (loss, g)
            in ref.items()}
    runs.update({who: inpaint_grad(torch, p, st, cfg, vgg, vcfg, x, m, gt,
                                   dt, dev)
                 for who, dt in (('card f64', torch.float64),
                                 ('card', torch.float32))})
    l64 = runs['f64'][0]
    lrel = abs(runs['card'][0] - l64) / abs(l64)
    check(np.isfinite(runs['card'][0]) and lrel <= XDEV_LOSS_BAR,
          f'legacy inpainting loss: card within {XDEV_LOSS_BAR} of the CPU '
          f'f64 ({lrel:.3e})')
    worst, worst64 = (0.0, 1.0, ''), 0.0
    for k, w in runs['f64'][1].items():
        scale = max(float(w.abs().max()), 1e-30)
        e64 = float((runs['card f64'][1][k] - w).abs().max()) / scale
        check(e64 <= LEGACY_F64_BAR, f'legacy inpainting gradient {k}: '
              f'the card\'s f64 within {LEGACY_F64_BAR} ({e64:.3e})')
        worst64 = max(worst64, e64)
        e = float((runs['card'][1][k] - w).abs().max()) / scale
        bar = max(XDEV_UPDATE_BAR, LEGACY_CPU_FACTOR * float(
            (runs['f32'][1][k] - w).abs().max()) / scale)
        check(e <= bar, f'legacy inpainting gradient {k}: card within '
              f'{bar:.3e} of the CPU f64 ({e:.3e})')
        if e / bar > worst[0] / worst[1]:
            worst = (e, bar, k)
    numbers['grad loss rel'], numbers['grad worst'] = lrel, worst[0]
    print(f'  legacy inpainting_loss gradient (PConvUNet layer_size '
          f'{LEGACY_PCONV[0]} train mode + VGG16, {side}^2; {card}): loss '
          f'{runs["card"][0]:.6f} vs CPU f64 {l64:.6f} (rel {lrel:.3e}); '
          f'worst leaf {worst[2]} {worst[0]:.3e} of its max (bar '
          f'{worst[1]:.3e}) over {len(runs["f64"][1])} leaves; the card\'s '
          f'f64 gradient {worst64:.3e}')


def instseg_scenes(fixture):
    """The first PCNET_CPU_IMAGES images of the fixture as phase 11 (a)
    prompts them: (modal, category, integer bboxes, expanded bboxes,
    image)."""
    import os
    import numpy as np
    from instaorder_tpu_torch.data import readers as R
    from instaorder_tpu_torch.data.image_io import read_rgb
    from instaorder_tpu_torch.eval.tester import expand_bbox
    insta, img_root = fixture
    reader = R.InstaOrderReader(insta)
    for i in range(PCNET_CPU_IMAGES):
        modal, cat, bboxes, _, fn = reader.get_image_instances(
            i, with_gt=False)[:5]
        # integer boxes (the reader's are COCO floats), as the
        # reference's instseg slices its box masks with them
        bboxes = np.round(bboxes).astype(int)
        yield (modal, cat, bboxes, expand_bbox(bboxes),
               read_rgb(os.path.join(img_root, fn)))


def instseg_cpu(net, fixture):
    """Phase 11 (a)'s CPU side: infer_instseg of the moved unet2 on the
    CPU without and with the CRF on each instseg_scenes image; for each,
    (masks, the completion probabilities, the probabilities the masks are
    held on: those, or their CRF refinement on the host). numpy."""
    import numpy as np
    from instaorder_tpu_torch.convert import to_torch
    from instaorder_tpu_torch.eval import amodal as AM
    from instaorder_tpu_torch.models import unet as U
    from instaorder_tpu_torch.ops.crf import densecrf
    from instaorder_tpu_torch.ops.resize import resize_cubic_u8
    from instaorder_tpu_torch.utils.geometry import crop_padding
    size = pcnet_config('InstaOrder')['data']['input_size']
    p, s, cfg = net
    comp = AM.AmodalCompleter(U.apply, cfg, to_torch(p), to_torch(s),
                              input_size=size, device='cpu')
    log = record_completer(comp, [])
    out = []
    for _, cat, bboxes, new, image in instseg_scenes(fixture):
        for crf in (False, True):
            want = AM.infer_instseg(comp, image, cat, bboxes, new,
                                    input_size=size, th=PCNET_TH,
                                    rgb=image if crf else None)
            pw = log[-1]['prob']
            ref = pw
            if crf:
                ref = np.stack([densecrf(np.stack([1.0 - q, q]),
                                         resize_cubic_u8(crop_padding(
                                             image, b, (0, 0, 0)), size,
                                             size))[1]
                                for q, b in zip(pw, new)])
            out.append(host_tree((want, pw, ref)))
    return out


def phase_instseg(torch, dev, card, numbers, net, fixture, ref):
    """infer_instseg (bbox prompts; without and with the dense CRF) of the
    moved unet2 on the fixture's first PCNET_CPU_IMAGES images, card
    against CPU (ref: instseg_cpu's): the probabilities within a tenth of
    the sure margin, the masks equal wherever the CPU's (CRF-refined)
    probability lies more than PCNET_SURE from th; infer_amodal_hull on
    every image."""
    import numpy as np
    from instaorder_tpu_torch.convert import to_torch
    from instaorder_tpu_torch.eval import amodal as AM
    from instaorder_tpu_torch.eval import heuristics as H
    from instaorder_tpu_torch.models import unet as U
    size = pcnet_config('InstaOrder')['data']['input_size']
    p, s, cfg = net
    comp = AM.AmodalCompleter(U.apply, cfg, to_torch(p), to_torch(s),
                              input_size=size, device=dev)
    log = record_completer(comp, [])
    ms = {False: [], True: []}
    perr, px, near_px, above = 0.0, 0, 0, []
    refs = iter(ref)
    for modal, cat, bboxes, new, image in instseg_scenes(fixture):
        for crf in (False, True):
            kw = dict(input_size=size, th=PCNET_TH,
                      rgb=image if crf else None)
            with quiet():
                t0 = time.perf_counter()
                got = AM.infer_instseg(comp, image, cat, bboxes, new, **kw)
                ms[crf].append((time.perf_counter() - t0) * 1e3)
            want, pw, ref = next(refs)
            perr = max(perr, float(np.abs(log[-1]['prob'] - pw).max()))
            for g, w, r in zip(got, want, ref):
                near = np.abs(r - PCNET_TH) <= PCNET_SURE
                check((g == w)[~near].all(), f'instseg (crf {crf}): card '
                      f'masks equal to the CPU\'s at every sure pixel')
                px += int((~near).sum())
                near_px += int(near.sum())
                above.append(float(w.mean()))
        order = H.infer_order_hull(modal)
        for grounded in (True, False):
            hulls = AM.infer_amodal_hull(modal, bboxes, order,
                                         order_grounded=grounded)
            check(all(h.dtype == np.uint8 and (h >= m).all()
                      for h, m in zip(hulls, modal)),
                  'infer_amodal_hull: uint8 hulls covering each mask')
    check(perr <= PCNET_SURE / 10, f'instseg: card vs CPU probabilities '
          f'within {PCNET_SURE / 10} ({perr:.3e})')
    share = float(np.mean(above))
    check(0.0 < share < 1.0, f'instseg: masks neither empty nor full '
          f'({share:.3f})')
    numbers['instseg prob err'] = perr
    numbers['instseg ms'] = {k: float(np.median(v)) for k, v in ms.items()}
    print(f'  instseg (unet2, {size}^2 box prompts, th {PCNET_TH}; '
          f'{PCNET_CPU_IMAGES} images): card vs CPU probabilities '
          f'{perr:.3e}; {px} mask pixels held equal, {near_px} within '
          f'{PCNET_SURE} of th not held; {100 * share:.2f}% of the pixels '
          f'set; per image {numbers["instseg ms"][False]:.2f} ms, with the '
          f'host CRF {numbers["instseg ms"][True]:.2f} ms ({card})')


def phase_last_modules(torch, dev, card, wrappers, pcnet=None, pool=None):
    """Phase 11 (module docstring): instseg / hull, the Mapillary PCNet-M
    Trainer, the legacy nets and the inpainting gradient, timed with
    StepTimer and one profiling.trace; no hand-written kernel launched.
    pcnet: phase 8's numbers (its moved unet2, numpy (params, stats,
    cfg), under 'net', and the CPU instseg under 'instseg'); None takes
    them from the pool's pcnet_cpu as phase 8 does (phase_pcnet_forward),
    for a run of this phase alone. Its CPU references from `pool`
    (own_pool). Returns {measurement: number}."""
    import json as _json
    import os
    import tempfile
    from instaorder_tpu_torch.data import synthetic
    from instaorder_tpu_torch.train import trainer as T
    from instaorder_tpu_torch.utils import profiling as PF

    t0 = time.perf_counter()
    numbers = {}
    for w in wrappers.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as root, own_pool(pool) as pool:
        pool.submit(*LEGACY_REFS)
        fixture = instaorder_fixture(root, PCNET_HW)
        if pcnet is None:
            ref = pool.result(*PCNET_REFS)
            pcnet = {'net': phase_pcnet_forward(torch, dev, card, {},
                                                ref['forward']),
                     'instseg': ref['instseg']}
        t1 = time.perf_counter()
        phase_instseg(torch, dev, card, numbers, pcnet['net'], fixture,
                      pcnet['instseg'])
        numbers['instseg s'] = time.perf_counter() - t1
        # the PCNet-M Trainer on Mapillary (the pcnet_m YAML, dataset
        # Mapillary)
        t1 = time.perf_counter()
        ann, mroot, mimg = synthetic.make_mapillary_fixture(
            root, **MAPILLARY_FIXTURE)
        three_steps(torch, T, 'pcnet_m', (ann, mimg), f'{root}/m',
                    data={'dataset': 'Mapillary', 'train_root': mroot,
                          'val_root': mroot})
        numbers['mapillary s'] = time.perf_counter() - t1
        # the legacy nets
        t1 = time.perf_counter()
        last = None
        forwards, grads = pool.result(*LEGACY_REFS)
        for name, (apply, trees, inputs) in legacy_nets(torch).items():
            tr, xs = legacy_xdev(torch, name, apply, trees, inputs, dev,
                                 card, numbers, forwards)
            if last is None:
                last = (name, apply, tr, xs)
        legacy_grad_xdev(torch, dev, card, numbers, grads)
        numbers['legacy s'] = time.perf_counter() - t1
        # one traced PConvUNet forward (utils/profiling.trace)
        name, apply, tr, xs = last
        with torch.no_grad(), quiet(), PF.trace(f'{root}/trace'):
            apply(tr, xs, False)
        with open(f'{root}/trace/trace.json') as f:
            events = _json.load(f)['traceEvents']
        kern = [e for e in events if e.get('cat') == 'kernel']
        busy = sum(e.get('dur', 0) for e in kern) / 1e3
        check(os.path.getsize(f'{root}/trace/trace.json') > 0 and kern,
              'profiling.trace: a Chrome trace holding the card\'s kernels')
        print(f'  profiling.trace of one {name} eval forward: '
              f'{len(kern)} device kernels, {busy:.3f} ms busy ({card})')
        numbers['trace kernels'] = len(kern)
    torch.cuda.synchronize()
    got = {n: w.launches for n, w in wrappers.items() if w.launches}
    check(not got, f'last modules: no kernel launched (JAX\'s counterparts '
          f'reach none): {got}')
    numbers['seconds'] = time.perf_counter() - t0
    print(f'last-modules phase: {numbers["seconds"]:.1f} s (instseg '
          f'{numbers["instseg s"]:.1f}, Mapillary training '
          f'{numbers["mapillary s"]:.1f}, legacy nets '
          f'{numbers["legacy s"]:.1f}); hand-written kernel launches 0 '
          f'({card})')
    return numbers


# ---- InstaDepthNet training (train/algos.make_insta_depth_net, compat/) -----
# the card-vs-CPU SGD step: samples at the YAMLs' 384^2 (the first
# distinct pair of order 0 or 1: the violation count's case)
DEPTH_XDEV = 1
# the loader-fed window of the _d Trainer (steps after a warm-up)
DEPTH_LOADER_WARMUP, DEPTH_LOADER_WINDOW = 5, 10
# a pixel whose disparity lies within this share of max |disparity| of
# the threshold it is compared with can count on one device and not on
# the other (disparity_order_violations)
VIOLATION_NEAR = 1e-5
# the MiDaS trunk's stages (ResNeXt-101 32x8d)
MIDAS_TRUNK = (3, 4, 23, 3)


def midas_oracle_file(torch, root, x, dev):
    """A full-width MidasNet state dict of seeded weights in the
    reference's names (tests/torch_ref.TorchMidasOracle, torch only), its
    last bias set so that the disparity of x (NHWC, on dev) is positive
    on about half of its pixels; written with torch.save to
    {root}/model-f6b98070.pt. Returns (the path, the module on dev, in
    eval mode)."""
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), 'tests'))
    from torch_ref import TorchMidasOracle
    torch.manual_seed(0)
    oracle = TorchMidasOracle(trunk_layers=MIDAS_TRUNK, features=256,
                              variant='midas').eval().to(dev)
    last = oracle.scratch.output_conv[4]
    pre = []
    hook = last.register_forward_hook(lambda m, i, o: pre.append(o))
    with torch.no_grad():
        oracle(x.permute(0, 3, 1, 2))
        hook.remove()
        last.bias -= pre[0].median()
    path = os.path.join(root, 'model-f6b98070.pt')
    torch.save({k: v.cpu() for k, v in oracle.state_dict().items()}, path)
    return path, oracle


def same_leaves(torch, got, want):
    """(leaves equal, leaves) of two trees of one structure (got on any
    device)."""
    from instaorder_tpu_torch.core.nn import tree_leaves
    g, w = tree_leaves(got), tree_leaves(want)
    return (sum(torch.equal(a.cpu(), b.cpu()) for a, b in zip(g, w)),
            len(w) if len(g) == len(w) else -1)


def phase_depth_ingest(torch, T, fixture, root, path, card):
    """(a): the _od YAML's Trainer with pretrained_weight at the oracle's
    file: every trunk and decoder leaf (and the trunk's statistics) the
    file's, the order branches at the init of the same seed."""
    from instaorder_tpu_torch.compat.torch_convert_midas import \
        midas_base_from_torch_state_dict
    from instaorder_tpu_torch.models.registry import get_backbone
    args = train_args('InstaDepthNet_od', fixture, 1)
    args.model['pretrained_weight'] = path
    t = T.Trainer(args, out_dir=f'{root}/ingest')
    quiet_logger(t)
    sd = torch.load(path, map_location='cpu', weights_only=True)
    base, base_s = midas_base_from_torch_state_dict(sd, t.net_cfg)
    fresh, fresh_s, _ = get_backbone('InstaDepthNet_od')['init'](
        torch.Generator().manual_seed(0), device='cpu')
    out = {}
    for k in t.params:
        want = (base[k], base_s.get(k)) if k in base else \
            (fresh[k], fresh_s.get(k))
        out[k] = [same_leaves(torch, t.params[k], want[0])]
        if want[1] is not None:
            out[k].append(same_leaves(torch, t.stats[k], want[1]))
    log = open(f'{root}/ingest/logs/log_train.txt').read()
    check(set(base) | {'do', 'oo'} == set(t.params) and
          all(a == b for v in out.values() for a, b in v) and
          '=> loaded pretrained_weight' in log,
          f'ingest: the trunk and decoder from the file, the branches at '
          f'their init ({out})')
    n = sum(b for k, v in out.items() if k not in ('do', 'oo')
            for _, b in v)
    print(f'  depth ingest ({card}): pretrained_weight {path} into the '
          f'InstaDepthNet_od Trainer on the card: {n} trunk and decoder '
          f'leaves equal to the file\'s, the do / oo branches equal to '
          f'the seed-0 init')
    del t


def violation_pixels(torch, d1, d2, e1, e2, order, distinct):
    """The pixels that losses.disparity_order_violations counts, as a bool
    tensor (4 terms, N, H, W): its comparisons, unsummed."""
    def terms(d, flip):
        d = d.float()
        max2 = torch.amax(torch.where(e2, d, torch.tensor(-3.4e38)),
                          dim=(-2, -1), keepdim=True)
        min1 = torch.amin(torch.where(e1, d, torch.tensor(3.4e38)),
                          dim=(-2, -1), keepdim=True)
        if not flip:
            return torch.stack([(d <= max2) & e1, (min1 <= d) & e2])
        return torch.stack([(d >= max2) & e1, (min1 >= d) & e2])
    sel = lambda v: v.view(1, -1, 1, 1)     # noqa: E731
    o0 = torch.cat([terms(d1, False), terms(d2, True)])
    o1 = torch.cat([terms(d1, True), terms(d2, False)])
    out = torch.where(sel(order == 0), o0,
                      torch.where(sel(order == 1), o1, torch.tensor(False)))
    return out & sel(distinct.bool())


def violation_near(torch, d1, d2, e1, e2, distinct):
    """The pixels of the eroded masks of distinct pairs within
    VIOLATION_NEAR of max |d| of the threshold they are compared with
    (mask 1's pixels against the max over mask 2, mask 2's against the
    min over mask 1, on either pass's disparity); left out, as exact on
    every device: a ReLU'd 0 against a threshold of 0, and a pixel of
    both masks that is the threshold itself."""
    n = 0
    for d in (d1.double(), d2.double()):
        scale = float(d.abs().max())
        for i in range(d.shape[0]):
            if not bool(distinct[i]) or not (e1[i].any() and e2[i].any()):
                continue
            both = (e1[i] & e2[i])
            for thr, m in ((d[i][e2[i]].max(), e1[i]),
                           (d[i][e1[i]].min(), e2[i])):
                v, own = d[i][m], both[m]
                near = ((v - thr).abs() <= VIOLATION_NEAR * scale) & \
                    ~((v == 0) & (thr == 0)) & ~(own & (v == thr))
                n += int(near.sum())
    return n


def depth_batch(ds, n):
    """n samples of a depth dataset: the first distinct pair of order 0
    or 1 (the violation count's case), then the first others."""
    from instaorder_tpu_torch.data.datasets import collate
    from instaorder_tpu_torch.data.loader import sample_rng
    picked, rest = [], []
    for i in range(len(ds)):
        smp = ds.sample(i, sample_rng(0, i))
        distinct = int(smp['is_overlap']) == 0 and \
            int(smp['depth_order']) in (0, 1)
        (picked if distinct and not picked else rest).append(smp)
        if picked and len(rest) >= n - 1:
            break
    return collate((picked + rest)[:n])


def violation_recorder(seen, who):
    """A record callback for train_step_on: the arguments of each
    losses.disparity_order_violations call of the step, on the CPU, into
    seen[who]."""
    @contextlib.contextmanager
    def rec():
        from instaorder_tpu_torch import losses as TL
        real = TL.disparity_order_violations

        def wrapped(*a):
            seen[who] = [v.detach().cpu() for v in a]
            return real(*a)
        TL.disparity_order_violations = wrapped
        try:
            yield
        finally:
            TL.disparity_order_violations = real
    return rec


def depth_xdev_cpu(name):
    """Reference job of phase 9 (b) for `name`: its net at full width from
    seed 0 and DEPTH_XDEV samples of the port's dataset on the InstaOrder
    fixture; the CPU's f64 step (recording the ReLU branch, the pool
    argmaxes and the min_max_norm extrema) and its f32 step on that
    branch, each with its violation-count inputs; this worker's peak
    RSS (GiB). numpy."""
    import resource
    import tempfile
    import torch
    from instaorder_tpu_torch import convert as CV
    from instaorder_tpu_torch.data.datasets import DATASETS
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.train import step as ST
    from instaorder_tpu_torch.train import trainer as T
    cpu = torch.device('cpu')
    with tempfile.TemporaryDirectory() as root:
        args = train_args(name, instaorder_fixture(root), 1)
        net = get_backbone(name)
        params, stats, cfg = net['init'](torch.Generator().manual_seed(0),
                                         device='cpu')
        params, stats = CV.to_numpy(params), CV.to_numpy(stats)
        ds = DATASETS[args.data['trainval_dataset']](args.data, 'train',
                                                     args.model['algo'])
        batch = depth_batch(ds, DEPTH_XDEV)
    seen = {}
    run = lambda who, branch=None, dtype=None: train_step_on(  # noqa: E731
        torch, T, ST, CV, net, cfg, args.model, params, stats, batch, cpu,
        branch, dtype, record=violation_recorder(seen, who))
    l64, p64, s64, branch, _, lg64 = run('cpu f64', None, torch.float64)
    l32, p32, s32, _, cflips, lg32 = run('cpu f32', branch)
    return dict(params=params, stats=stats, cfg=cfg, batch=batch,
                f64=(l64, p64, s64, lg64), f32=(l32, p32, s32, cflips, lg32),
                branch=host_tree(branch), seen=host_tree(seen),
                rss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                / 2 ** 20)


# phase 9 (b)'s reference jobs: (pool label, job, its argument)
DEPTH_XDEV_REFS = {n: (f'depth xdev CPU f64 + f32 steps {n}', depth_xdev_cpu,
                       n) for n in ('InstaDepthNet_d', 'InstaDepthNet_od')}


def phase_depth_xdev(torch, fixture, dev, card, numbers, pool):
    """(b): one SGD step of the _d and _od YAMLs at full width on
    DEPTH_XDEV samples of 384^2 on the card against the CPU's f64 and f32
    steps (depth_xdev_cpu, from the pool), every run on the CPU f64 run's
    ReLU branch and pool argmaxes; the card's step against the CPU's f64
    one, and the violation count against its count."""
    import numpy as np
    from instaorder_tpu_torch import convert as CV
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.train import step as ST
    from instaorder_tpu_torch.train import trainer as T
    for name in ('InstaDepthNet_d', 'InstaDepthNet_od'):
        t0 = time.perf_counter()
        ref = pool.result(*DEPTH_XDEV_REFS[name])
        params, stats, cfg, batch = (ref[k] for k in ('params', 'stats',
                                                      'cfg', 'batch'))
        l64, p64, s64, lg64 = ref['f64']
        l32, p32, s32, cflips, lg32 = ref['f32']
        branch = torch_tree(torch, ref['branch'])
        seen = torch_tree(torch, ref['seen'])
        args = train_args(name, fixture, 1)
        lg, pg, sg, _, flips, lgc = train_step_on(
            torch, T, ST, CV, get_backbone(name), cfg, args.model, params,
            stats, batch, dev, branch, record=violation_recorder(seen,
                                                                 'card'))
        maps = {k: violation_pixels(torch, *v) for k, v in seen.items()}
        counts = {k: int(m.sum()) for k, m in maps.items()}
        hw = seen['card'][0].shape[-2] * seen['card'][0].shape[-1]
        check(all(abs(counts[k] * args.model['dorder_weight'] / hw -
                      lgs['loss_disp_order']) <= 1e-6 * max(1.0, counts[k])
                  for k, lgs in (('card', lgc), ('cpu f64', lg64))),
              f'{name}: the violation pixels sum to the logged count')
        near = violation_near(torch, *[seen['cpu f64'][i]
                                       for i in (0, 1, 2, 3, 5)])
        flipped = int((maps['card'] != maps['cpu f64']).sum())
        flipped32 = int((maps['cpu f32'] != maps['cpu f64']).sum())
        dorder = lambda lgs: lgs['loss_disp_order']  # noqa: E731
        out, upd_leaves = {}, {}
        for who, (l, lgs, p, s) in (('card f32', (lg, lgc, pg, sg)),
                                    ('CPU f32', (l32, lg32, p32, s32))):
            smooth = l - dorder(lgs)        # the differentiable terms
            upd_leaves[who] = {}
            out[who] = (abs(l - l64) / abs(l64),
                        abs(smooth - (l64 - dorder(lg64))) /
                        abs(l64 - dorder(lg64)),
                        leaf_worst(p, p64, params, 'params',
                                   leaves=upd_leaves[who]),
                        leaf_worst(s, s64, None, 'stats'))
            lrel, srel, upd, sts = out[who]
            print(f'  depth one SGD step {name} ({DEPTH_XDEV} samples, '
                  f'{args.data["input_size"]}^2; {card}): {who} vs CPU f64: '
                  f'loss {l:.7f} vs {l64:.7f} (rel {lrel:.3e}; without the '
                  f'count {srel:.3e}); worst update {upd[1]} {upd[0]:.3e} of '
                  f'its max |update|; worst stats {sts[1]} {sts[0]:.3e}')
        rss = ref['rss']
        print(f'  depth step {name}: violation count card {counts["card"]}, '
              f'CPU f64 {counts["cpu f64"]}, CPU f32 {counts["cpu f32"]}; '
              f'{near} pixels within {VIOLATION_NEAR} of a threshold on the '
              f'CPU f64 run; {flipped} pixels counted on one of card and '
              f'CPU f64 only (CPU f32: {flipped32}); {flips[0]} (CPU f32 '
              f'{cflips[0]}) of {sum(int(m.numel()) for m in branch[0])} '
              f'ReLU inputs and {flips[1]} (CPU f32 {cflips[1]}) of '
              f'{sum(int(i.numel()) for i in branch[1])} pool windows on '
              f'the other side on the card, {flips[2]} of them not exact '
              f'ties, {flips[3]} beyond 1e-5 ({branch[2][0]} windows tied '
              f'on the CPU f64 run); {flips[4]} (CPU f32 {cflips[4]}) of '
              f'{sum(2 * int(m[0].shape[0]) for m in branch[3])} min / max '
              f'of min_max_norm on other pixels; the reference worker\'s '
              f'peak RSS {rss:.1f} GiB; {time.perf_counter() - t0:.1f} s')
        top = sorted(upd_leaves['card f32'].items(), key=lambda kv: -kv[1][0])
        print(f'  depth step {name}: the worst card updates (error over the '
              f'leaf\'s max |f64 update|, that max; the CPU f32 run\'s '
              f'error): ' + '; '.join(
                  f'{k} {e:.3e} ({sc:.3e}; {upd_leaves["CPU f32"][k][0]:.3e})'
                  for k, (e, sc) in top[:4]))
        numbers[f'xdev {name}'] = out['card f32']
        numbers[f'violations {name}'] = (counts, near, flipped)
        lrel, srel, upd, sts = out['card f32']
        check(np.isfinite(lg) and (lrel if near == 0 else srel)
              <= XDEV_LOSS_BAR,
              f'{name}: card loss within {XDEV_LOSS_BAR} of the CPU\'s f64 '
              f'({"with" if near == 0 else "without"} the count)')
        check(near > 0 or counts['card'] == counts['cpu f64'],
              f'{name}: the violation count equal where no pixel is near a '
              f'threshold ({counts})')
        bar = {k: max(XDEV_UPDATE_BAR, XDEV_CPU_FACTOR * e)
               for k, (e, _) in upd_leaves['CPU f32'].items()}
        worst = max(bar, key=lambda k: upd_leaves['card f32'][k][0] / bar[k])
        check(upd_leaves['card f32'][worst][0] <= bar[worst],
              f'{name}: every update within max({XDEV_UPDATE_BAR}, '
              f'{XDEV_CPU_FACTOR} x the CPU f32 run\'s error) of its max '
              f'({worst}: {upd_leaves["card f32"][worst][0]:.3e}, bar '
              f'{bar[worst]:.3e})')
        check_stats(name, sg, s32, s64, card)


def phase_depth_flow(torch, T, fixture, root, oracle_path, oracle, x384,
                     card):
    """(c): the _d YAML through the Trainer on the card (its
    pretrained_weight missing: a warning), 4 steps, a checkpoint, a new
    Trainer resuming to 6, validate() finite; the Tester's disparity
    route and eval_diw on the step-6 checkpoint; make_disp_forward on the
    oracle's .pt (compat) against the oracle; _od 3 steps."""
    import os
    import numpy as np
    from instaorder_tpu_torch.core.nn import tree_leaves
    from instaorder_tpu_torch.data import readers as R
    from instaorder_tpu_torch.data import synthetic
    from instaorder_tpu_torch.eval import disp as TDISP
    from instaorder_tpu_torch.eval.pipeline import DisparityOrderPredictor
    from instaorder_tpu_torch.eval.tester import Tester
    name, out = 'InstaDepthNet_d', f'{root}/d'
    flow = dict(print_freq=2, save_freq=4, val_iter=2)
    t = T.Trainer(train_args(name, fixture, 4, **flow), out_dir=out)
    quiet_logger(t)
    check(t.device.type == 'cuda', f'{name}: the Trainer runs on the card')
    t.train()
    ck4 = f'{out}/checkpoints/ckpt_iter_4.ckpt'
    log = open(f'{out}/logs/log_train.txt').read()
    check(t.curr_step == 4 and os.path.isfile(ck4) and
          'caution: pretrained_weight' in log and 'not found' in log,
          f'{name}: the missing pretrained_weight warned; 4 steps and a '
          f'checkpoint at 4')
    t2 = T.Trainer(train_args(name, fixture, 6, **flow), out_dir=f'{out}2')
    quiet_logger(t2)
    t2.load(ck4, resume=True)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(t.params),
                                                 tree_leaves(t2.params)))
    check(t2.start_iter == 4 and same,
          f'{name} resume: start_iter 4 and the params equal')
    del t
    t2.train()
    val = t2.validate()
    check(t2.curr_step == 6 and all(np.isfinite(v) for v in val.values()),
          f'{name}: resumed to 6 and validate() is finite ({val})')
    ck6 = f'{out}2/checkpoints/ckpt_iter_6.ckpt'
    del t2
    cfg = tester_disp_config('InstaOrder/InstaDepthNet_d')
    args = tester_args(cfg, root, {'InstaOrder': fixture}, '', 'all', ck6)
    args.disp_select_method = 'median'
    tester = Tester(args, logger=quiet_log())
    res = tester.run()
    check(isinstance(tester.predictor, DisparityOrderPredictor) and
          tester.predictor.device.type == 'cuda' and
          all(np.isfinite(v) for v in res.values()),
          f'{name}: the Tester\'s disparity route on the card, on the '
          f'step-6 checkpoint ({res})')
    diw = synthetic.make_diw_fixture(root + '/diw', DIW_IMAGES)
    norm = disp_config('DIW/InstaDepthNet_d').data
    whdr = TDISP.eval_diw(TDISP.make_disp_forward(name, ck6),
                          R.DIWReader(*diw, norm['data_mean'],
                                      norm['data_std']),
                          log=lambda *a: None)
    check(whdr['n'] == DIW_IMAGES and np.isfinite(whdr['whdr']),
          f'{name}: eval_diw on the step-6 checkpoint ({whdr})')
    print(f'  depth train flow {name} (batch {args.data.get("batch_size")}'
          f', 384^2): 4 steps, checkpoint, resume, 6 steps, validate '
          f'{val}; Tester (disparity route, median) {res}; eval_diw '
          f'{whdr} ({card})')
    # a torch .pt through compat: the port's forward against the module
    # that wrote the file, on the card
    fwd = TDISP.make_disp_forward('midas_pretrained', oracle_path)
    with torch.no_grad():
        got = fwd(x384)
        want = oracle(x384.permute(0, 3, 1, 2))
    err = worst_rel(got, want.cpu())
    share = float((want > 0).float().mean())
    check(err <= MIDAS_BAR and share > 0.2,
          f'the .pt MidasNet through compat within {MIDAS_BAR} of the '
          f'torch module ({err:.3e}; positive share {share:.3f})')
    print(f'  make_disp_forward on the .pt (compat): disparity within '
          f'{err:.3e} of max |the torch module\'s| at 384^2, '
          f'{100 * share:.1f}% of its pixels positive ({card})')
    three_steps(torch, T, 'InstaDepthNet_od', fixture, f'{root}/od',
                every_leaf=False)


def quiet_log():
    import logging
    log = logging.getLogger('chip_smoke.depth')
    log.addHandler(logging.NullHandler())
    log.propagate = False
    return log


def phase_depth(torch, dev, card, wrappers, pool=None):
    """InstaDepthNet training on the card (module docstring, phase 9),
    its CPU references from `pool` (own_pool). Returns {measurement:
    number}."""
    import os
    import tempfile
    from instaorder_tpu_torch.data import readers as R
    from instaorder_tpu_torch.data.image_io import read_rgb
    from instaorder_tpu_torch.train import trainer as T

    t0 = time.perf_counter()
    numbers = {}
    for w in wrappers.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as root, own_pool(pool) as pool:
        fixture = instaorder_fixture(root)
        insta, img = fixture
        fn = R.InstaOrderReader(insta).get_image_instances(
            0, with_gt=False)[4]
        x384 = midas_image(torch, read_rgb(os.path.join(img, fn)), dev)
        path, oracle = midas_oracle_file(torch, root, x384, dev)
        phase_depth_ingest(torch, T, fixture, root, path, card)
        phase_depth_xdev(torch, fixture, dev, card, numbers, pool)
        phase_depth_flow(torch, T, fixture, root, path, oracle, x384, card)
        del oracle
        # the numbers: the _d step on a fixed batch and the loader-fed
        # window
        bt, dt, alone, ta, batch = time_loader_fed(
            T, 'InstaDepthNet_d', fixture, f'{root}/w',
            warmup=DEPTH_LOADER_WARMUP, window=DEPTH_LOADER_WINDOW)
        ms, peak = time_train_step(torch, T, ta, batch)
        n, d = ta.args.data['batch_size'], ta.args.data
        numbers.update(step_ms=ms, peak_gib=peak, batch_ms=bt, data_ms=dt,
                       alone_ms=alone)
        print(f'  depth train InstaDepthNet_d {d["input_size"]}^2 batch {n}: '
              f'device step {ms:.2f} ms (median of {TIMING_REPS} after '
              f'{TIMING_WARMUP}, fixed batch on the card) = '
              f'{n / ms * 1e3:.2f} samples/s, peak memory {peak:.2f} GiB; '
              f'{d["workers"]} thread workers: Trainer loader-fed batch time '
              f'{bt:.2f} ms = {n / bt * 1e3:.2f} samples/s, data time '
              f'{dt:.2f} ms (steps {DEPTH_LOADER_WARMUP + 1}-'
              f'{DEPTH_LOADER_WARMUP + DEPTH_LOADER_WINDOW}); the loader '
              f'alone {alone:.2f} ms a batch ({card})')
        del ta
    torch.cuda.synchronize()
    got = {n: w.launches for n, w in wrappers.items() if w.launches}
    check(not got, f'depth training: no kernel launched (JAX\'s path '
          f'reaches none): {got}')
    numbers['seconds'] = time.perf_counter() - t0
    print(f'depth train phase: {numbers["seconds"]:.1f} s; hand-written '
          f'kernel launches 0 ({card})')
    return numbers


# ---- data parallel (parallel/, train/step.py, the Trainer's ranks) ----------
# (a) ranks sharing the one card (gloo: NCCL refuses two ranks on one
# device) and the pairs a rank of the card-vs-CPU data-parallel step;
# (d) at most this many cards
DP_WORLD = 2
DP_PAIRS_PER_RANK = 2
DP_CARDS = 4
# the Trainer flow's settings (phase 6's train_flow)
DP_FLOW = dict(print_freq=2, save_freq=4, val_iter=2)
# the all-reduce's timing (median of DP_REPS after a warm-up); a spawned
# world's time limit (a rank that raises or outlives it fails the phase;
# the NCCL duplicate-device probe's is recorded instead)
DP_REPS = 5
DP_TIMEOUT = 600
NCCL_DUP_TIMEOUT = 120


def dp_spawn(torch, fn, world, workdir, job, timeout=DP_TIMEOUT,
             may_hang=False):
    """fn(rank, world, workdir, job) in `world` spawned, non-daemonic
    processes, each writing its result to workdir/rank{r}.pt. A rank that
    raises fails the phase (torch's ProcessRaisedException), as does a
    world still running after `timeout` s (killed), unless may_hang:
    then None. Returns the ranks' results in rank order."""
    import os
    import torch.multiprocessing as mp
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(fn, args=(world, workdir, job), nprocs=world,
                             join=False, daemon=False, start_method='spawn')
    deadline = time.time() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            check(may_hang, f'{fn.__name__}: ranks still running after '
                  f'{timeout} s')
            return None
    return [torch.load(f'{workdir}/rank{r}.pt', weights_only=False)
            for r in range(world)]


def dp_reference_cpu(world):
    """Reference job of phase 10: the CPU's reference for a world-`world`
    step of InstaOrderNet_o at full width (seed 0, kaiming) on
    DP_PAIRS_PER_RANK * world pairs of the port's dataset on the
    InstaOrder fixture: the port's one-device step on each rank's shard
    in f64 (recording the shard's ReLU branch, pool argmaxes and extrema)
    and in f32 on that branch, the shards' losses, new params and
    statistics averaged by hand (a first SGD step is linear in the
    gradient). Returns the net, the batch and the branches (numpy) and
    {'f64' / 'f32': (loss, params, stats)}."""
    import tempfile
    import numpy as np
    import torch
    from instaorder_tpu_torch import convert as CV
    from instaorder_tpu_torch.core.nn import tree_map
    from instaorder_tpu_torch.data.datasets import DATASETS, collate
    from instaorder_tpu_torch.data.loader import sample_rng
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.parallel import make_mesh, shard_batch
    from instaorder_tpu_torch.train import step as ST
    from instaorder_tpu_torch.train import trainer as T
    cpu = torch.device('cpu')
    with tempfile.TemporaryDirectory() as root:
        args = train_args('InstaOrderNet_o', instaorder_fixture(root), 1)
        net = get_backbone('resnet50_cls')
        params, stats, cfg = net['init'](
            torch.Generator().manual_seed(0), weight_init='kaiming_out',
            device='cpu', **args.model['backbone_param'])
        params, stats = CV.to_numpy(params), CV.to_numpy(stats)
        ds = DATASETS[args.data['trainval_dataset']](args.data, 'train',
                                                     args.model['algo'])
        batch = collate([ds.sample(i % len(ds), sample_rng(0, i))
                         for i in range(DP_PAIRS_PER_RANK * world)])
    mesh = make_mesh(devices=['cpu'] * world)
    runs, branches = {'f64': [], 'f32': []}, []
    for r in range(world):
        shard = shard_batch(batch, mesh, r)
        l64, p64, s64, branch, _, _ = train_step_on(
            torch, T, ST, CV, net, cfg, args.model, params, stats, shard,
            cpu, None, torch.float64)
        l32, p32, s32, _, _, _ = train_step_on(
            torch, T, ST, CV, net, cfg, args.model, params, stats, shard,
            cpu, branch)
        runs['f64'].append((l64, p64, s64))
        runs['f32'].append((l32, p32, s32))
        branches.append(host_tree(branch))

    def mean(trees):
        return tree_map(lambda *a: np.mean(np.stack(
            [np.asarray(x, np.float64) for x in a]), 0), *trees)
    ref = {k: (float(np.mean([x[0] for x in v])), mean([x[1] for x in v]),
               mean([x[2] for x in v])) for k, v in runs.items()}
    return dict(params=params, stats=stats, cfg=cfg, batch=batch,
                branches=branches, ref=ref)


def dp_ref_job(world):
    """Phase 10's reference job at `world`: (pool label, job, world)."""
    return (f'data parallel CPU f64 + f32 shard steps world {world}',
            dp_reference_cpu, world)


def dp_reference(torch, pool, world, path):
    """dp_reference_cpu(world) from the pool, its net, batch and branches
    written to `path` for the ranks. Returns (params, {'f64' / 'f32':
    (loss, params, stats)})."""
    out = pool.result(*dp_ref_job(world))
    torch.save({'params': out['params'], 'stats': out['stats'],
                'cfg': out['cfg'], 'batch': out['batch'],
                'branches': torch_tree(torch, out['branches'])}, path)
    return out['params'], out['ref']


def dp_flow(torch, T, fixture, out, mesh):
    """(a)'s Trainer flow as this rank of `mesh`: the InstaOrderNet_o
    YAML for 4 steps (a checkpoint at 4, rank 0's), a new Trainer
    resuming it (start_iter 4, params equal) to 6, validate(); the
    ranks' params then, held against rank 0's broadcast; the all-reduce
    of a tree of the params' shapes (the step's gradient bucket) and the
    step on a fixed batch of this rank's stream, timed."""
    import os
    import numpy as np
    import torch.distributed as dist
    from instaorder_tpu_torch.core.nn import tree_leaves
    from instaorder_tpu_torch.parallel import all_reduce_mean
    saved = []

    def trainer(total, out_dir):
        t = T.Trainer(train_args('InstaOrderNet_o', fixture, total,
                                 **DP_FLOW), out_dir=out_dir, mesh=mesh)
        quiet_logger(t)
        real = t.save
        t.save = lambda step: saved.append(real(step)) or saved[-1]
        return t
    t = trainer(4, out)
    t.train()
    dist.barrier()          # rank 0's checkpoint is written
    t2 = trainer(6, f'{out}2')
    t2.load(f'{out}/checkpoints/ckpt_iter_4.ckpt', resume=True)
    res = {'resume_equal': all(torch.equal(a, b) for a, b in zip(
        tree_leaves(t.params), tree_leaves(t2.params)))}
    t2.train()
    val = t2.validate()
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(t2.params)])
    rank0 = flat.clone()
    dist.broadcast(rank0, 0)
    res.update(saved=saved, start_iter=t2.start_iter,
               curr_step=t2.curr_step, val_loss=float(val['loss']),
               params_equal=bool(torch.equal(flat, rank0)),
               n_values=int(flat.numel()),
               ckpts=sorted(os.listdir(f'{out}/checkpoints')) +
               sorted(os.listdir(f'{out}2/checkpoints'))
               if dist.get_rank() == 0 else None)
    ms = []
    for i in range(DP_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_mean(t2.params)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res['allreduce_ms'] = float(np.median(ms[1:]))
    it = iter(t2._make_loader('train'))
    batch = next(it)
    it.close()
    res['step_ms'], res['peak_gib'] = time_train_step(torch, T, t2, batch)
    res['pairs'] = int(batch['rgb'].shape[0])
    return res


def dp_rank(rank, world, workdir, job):
    """One rank of phase 10's data-parallel runs (dp_spawn): joins the
    group (job['backend'] on job['mesh'][rank]); with job['xdev'], the
    data-parallel SGD step on its shard of the reference's batch, on its
    shard's f64 branch; with job['flow'], dp_flow."""
    import torch
    import torch.distributed as dist
    from instaorder_tpu_torch import convert as CV
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.parallel import (init_data_parallel, make_mesh,
                                               shard_batch)
    from instaorder_tpu_torch.train import step as ST
    from instaorder_tpu_torch.train import trainer as T
    mesh = make_mesh(devices=job['mesh'])
    dev = mesh[rank]
    init_data_parallel(rank, world, dev, backend=job['backend'],
                       init_method=f'file://{workdir}/rendezvous')
    out = {'device': str(dev), 'backend': dist.get_backend()}
    try:
        if 'xdev' in job:
            ref = torch.load(job['xdev'], weights_only=False)
            args = train_args('InstaOrderNet_o', job['fixture'], 1)
            loss, p, s, _, flips, _ = train_step_on(
                torch, T, ST, CV, get_backbone('resnet50_cls'), ref['cfg'],
                args.model, ref['params'], ref['stats'],
                shard_batch(ref['batch'], mesh, rank), dev,
                ref['branches'][rank], mesh=mesh)
            out['xdev'] = (loss, p, s) if rank == 0 else (loss, None, None)
            out['flips'] = flips
            del ref
        if job.get('flow'):
            out.update(dp_flow(torch, T, job['fixture'],
                               f'{workdir}/flow', mesh))
    finally:
        dist.destroy_process_group()
    torch.save(out, f'{workdir}/rank{rank}.pt')


def nccl_dup_rank(rank, world, workdir, job):
    """NCCL with every rank on cuda:0: its answer (NCCL refuses a
    duplicate device) recorded as text."""
    import os
    import torch
    import torch.distributed as dist
    from instaorder_tpu_torch.parallel import init_data_parallel
    try:
        init_data_parallel(rank, world, 'cuda:0',
                           init_method=f'file://{workdir}/rendezvous')
        t = torch.ones(4, device='cuda:0')
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f'accepted: {t.tolist()}'
    except RuntimeError as e:       # the refusal is the expected answer
        msg = f'{type(e).__name__}: ' + ' '.join(str(e).split())[:300]
    torch.save(msg, f'{workdir}/rank{rank}.pt')
    os._exit(0)     # a refused communicator may block a normal exit


def check_dp_ranks(torch, name, ranks, ref, params, card):
    """A world's results: the data-parallel step against the CPU's f64
    reference at phase 6's bars (loss 1e-5 relative, updates 1e-3 of each
    leaf's max, statistics through check_stats), every rank's loss equal;
    the Trainer flow: 4 steps, the checkpoints at 4 and 6 written by rank
    0 alone, the resume equal, 6 steps, validate() finite, the ranks'
    params equal on every value."""
    import numpy as np
    l64, p64, s64 = ref['f64']
    l32, p32, s32 = ref['f32']
    lg, pg, sg = ranks[0]['xdev']
    check(all(r['xdev'][0] == lg for r in ranks),
          f'{name}: every rank logs the same (averaged) loss')
    lrel = abs(lg - l64) / abs(l64)
    upd = leaf_worst(pg, p64, params, 'params')
    for who, (l, p) in (('card', (lg, pg)), ('CPU f32', (l32, p32))):
        print(f'  {name} data-parallel SGD step vs the CPU f64 one-device '
              f'steps averaged ({len(ranks)} x {DP_PAIRS_PER_RANK} pairs): '
              f'{who} loss {l:.6f} vs {l64:.6f} (rel '
              f'{abs(l - l64) / abs(l64):.3e}); worst update '
              f'{leaf_worst(p, p64, params, "params")} ({card})')
    print(f'  {name}: ReLU / pool flips against the CPU f64 branch by rank '
          f'{[r["flips"][:2] for r in ranks]}')
    check(np.isfinite(lg) and lrel <= XDEV_LOSS_BAR,
          f'{name}: loss within {XDEV_LOSS_BAR} of the CPU\'s ({lrel:.3e})')
    check(upd[0] <= XDEV_UPDATE_BAR,
          f'{name}: every update within {XDEV_UPDATE_BAR} ({upd})')
    check_stats(name, sg, s32, s64, card)
    r0 = ranks[0]
    check(r0['ckpts'] == ['ckpt_iter_4.ckpt', 'ckpt_iter_6.ckpt'],
          f'{name}: checkpoints at 4 and 6 ({r0["ckpts"]})')
    check(all(len(r['saved']) == 2 for r in ranks) and all(r0['saved'])
          and all(p is None for r in ranks[1:] for p in r['saved']),
          f'{name}: rank 0 alone writes the checkpoints')
    for r in ranks:
        check(r['resume_equal'] and r['start_iter'] == 4 and
              r['curr_step'] == 6 and np.isfinite(r['val_loss']),
              f'{name} rank {r["device"]}: resume at 4 with the params '
              f'equal, 6 steps, validate() finite')
        check(r['params_equal'], f'{name}: the ranks\' params equal on '
              f'every value ({r["n_values"]})')
    print(f'  {name} Trainer flow: 4 steps, checkpoint (rank 0), resume, '
          f'6 steps, validate loss {r0["val_loss"]:.4f}; the {len(ranks)} '
          f'ranks\' {r0["n_values"]} param values equal')


def dp_nccl_world1(torch, T, ST, fixture, dev, workdir):
    """(b): the world-1 step on a fixed batch of the YAML's 32 pairs
    (timed), then one step through the NCCL path (a process group of
    one, mesh [dev]) against build_train_step without a mesh on the same
    inputs, cuDNN deterministic for both: equal on every value; and the
    NCCL all-reduce of the params' tree and of one flat bucket of its
    size, timed. Returns (world-1 step ms, pairs, the two all-reduce
    ms)."""
    import numpy as np
    import torch.distributed as dist
    from instaorder_tpu_torch.core.nn import tree_leaves
    from instaorder_tpu_torch.parallel import (all_reduce_mean,
                                               init_data_parallel)
    t = T.Trainer(train_args('InstaOrderNet_o', fixture, 1), device=dev,
                  out_dir=f'{workdir}/w1')
    quiet_logger(t)
    it = iter(t._make_loader('train'))
    batch = next(it)
    it.close()
    ms1, _ = time_train_step(torch, T, t, batch)
    init_data_parallel(0, 1, dev, init_method=f'file://{workdir}/nccl1')
    try:
        check(dist.get_backend() == 'nccl', 'the card\'s default backend')
        xb = T.batch_to_device(batch, t.device)
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            a, b = (ST.build_train_step(t.loss_fn, t.optimizer, m)(
                t.params, t.stats, t.opt_state, xb, t.lr_fn(0))
                for m in (None, [t.device]))
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = det
        la, lb = tree_leaves(list(a)), tree_leaves(list(b))
        differ = sum(not torch.equal(x, y) for x, y in zip(la, lb))
        print(f'  (b) NCCL world 1: one step through the mesh path vs '
              f'without: {differ} of {len(la)} leaves differ')
        check(len(la) == len(lb) and differ == 0,
              'NCCL world 1: the step equal on every value')
        # the tree's all-reduce, and one all_reduce of a bucket of the
        # same size already flat (the difference: the tree's host work)
        bucket = torch.zeros(sum(x.numel() for x in tree_leaves(t.params)),
                             device=dev)
        ms = {}
        for name, fn in (('tree', lambda: all_reduce_mean(t.params)),
                         ('flat', lambda: dist.all_reduce(bucket))):
            ms[name] = []
            for i in range(DP_REPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.destroy_process_group()
    return (ms1, int(batch['rgb'].shape[0]), float(np.median(ms['tree'][1:])),
            float(np.median(ms['flat'][1:])))


def dp_predictors(torch, serving, resnet, TPL, wrappers, calib_x, dev, mesh,
                  card):
    """(c) / (d): make_v2_predictor (compute_dtype f32, the dual-head net)
    and make_folded_predictor (f32, identity,down,stem) with mesh=`mesh`
    against the same predictors unsharded, on phase 4's scenes: the
    matrices equal, the launches of every call (the prep once, the
    model's kernels once for each mesh device), and every model kernel's
    entry point launched on every device of the mesh (ops/_build.launch
    recorded)."""
    from instaorder_tpu_torch.ops import _build
    nets = predictor_nets(torch, resnet, dev,
                          ('InstaOrderNet_o', 'InstaOrderNet_od'))
    scenes = pred_scenes(serving)
    k = len(mesh)
    kw = dict(patch_or_image='patch', input_size=OUT, prep_impl='pallas5',
              device=dev)
    preds = [
        ('v2-f32 d2', 'InstaOrderNet_od',
         lambda n, **m: TPL.make_v2_predictor(
             *n, 'InstaOrderNet_od', [calib_x], compute_dtype=torch.float32,
             **kw, **m), {PREP: 1, STAGE: k, DOWN: 3 * k, IDEN: 10 * k}),
        ('f32 d2', 'InstaOrderNet_o',
         lambda n, **m: TPL.make_folded_predictor(
             *n, 'InstaOrderNet_o', use_pallas=KFEATS, **kw, **m),
         {PREP: 1, IDEN16: 5 * k, DOWN16: 3 * k, STEM: k})]
    where = {}
    real = _build.launch

    def launch(entry, d, *a):
        where.setdefault(entry, set()).add(str(d))
        return real(entry, d, *a)
    _build.launch = launch
    try:
        for name, method, make, expected in preds:
            single = make(nets[method])
            sharded = make(nets[method], mesh=mesh)
            dual = method == 'InstaOrderNet_od'
            for n, scene in zip(PRED_INSTANCES, scenes):
                got, counts = pred_launches(
                    torch, wrappers, lambda: sharded.infer_occ_order(*scene))
                check(counts == expected, f'mesh predictor {name} N={n}: '
                      f'launches {counts}, expected {expected}')
                check((got == single.infer_occ_order(*scene)).all(),
                      f'mesh predictor {name} N={n}: matrices equal')
                if dual:
                    for g, w in zip(sharded.infer_occ_depth_order(*scene),
                                    single.infer_occ_depth_order(*scene)):
                        check((g == w).all(), f'mesh predictor {name} '
                              f'N={n}: occ / depth matrices equal')
            ms = {}
            for who, pred in (('unsharded', single), ('mesh', sharded)):
                t = []
                with quiet():
                    for _ in range(PRED_REPS + 1):
                        t0 = time.perf_counter()
                        pred.infer_occ_order(*scenes[-1])
                        t.append((time.perf_counter() - t0) * 1e3)
                ms[who] = sorted(t[1:])[PRED_REPS // 2]
            print(f'  mesh predictor {name} over {[str(d) for d in mesh]}: '
                  f'matrices equal to the unsharded predictor\'s on '
                  f'{len(scenes)} scenes, launches a call {expected}; '
                  f'infer_occ_order N={PRED_INSTANCES[-1]} {ms["mesh"]:.3f} '
                  f'ms, unsharded {ms["unsharded"]:.3f} ms ({card})')
            del single, sharded
    finally:
        _build.launch = real
    devs = {str(torch.device(d)) for d in mesh}
    for entry, on in where.items():
        if entry != 'io_prep_pairs':
            check(devs <= on, f'{entry} launched on every mesh device '
                  f'({sorted(on)})')
    return {e: sorted(on) for e, on in where.items()}


def dp_cli(fixture, root, world):
    """(d): `python -m instaorder_tpu_torch.cli.train --n-devices world`
    on the InstaOrderNet_o YAML's settings (the fixture's paths): 4 steps
    and a checkpoint, then --auto-resume to 6 and validate."""
    import json as js
    import os
    import yaml
    repo = os.path.dirname(os.path.abspath(__file__))
    out = f'{root}/cli'
    for total, extra in ((4, []), (6, ['--auto-resume'])):
        a = train_args('InstaOrderNet_o', fixture, total, **DP_FLOW)
        cfg = js.loads(js.dumps({'model': a.model,
                                 'data': dict(a.data, base_dir=''),
                                 'trainer': a.trainer}))
        path = f'{root}/cli_{total}.yaml'
        with open(path, 'w') as f:
            yaml.safe_dump(cfg, f)
        run = subprocess.run(
            [sys.executable, '-m', 'instaorder_tpu_torch.cli.train',
             '--config', path, '--n-devices', str(world), '--out-dir', out,
             '--seed', '0', *extra], cwd=repo, capture_output=True,
            text=True, timeout=DP_TIMEOUT)
        check(run.returncode == 0, f'cli.train --n-devices {world}: '
              f'{run.stderr[-2000:]}')
    ckpts = sorted(os.listdir(f'{out}/checkpoints'))
    log = open(f'{out}/logs/log_train.txt').read()
    check(ckpts == ['ckpt_iter_4.ckpt', 'ckpt_iter_6.ckpt'] and
          'Validation Iter: [6]' in log and 'iter 4)' in log,
          f'cli.train --n-devices {world}: checkpoints {ckpts}, resumed at '
          f'4, validated at 6')
    print(f'  (d) cli.train --n-devices {world}: 4 steps, checkpoint, '
          f'--auto-resume to 6, validate')


def phase_data_parallel(torch, serving, resnet, TPL, wrappers, calib_x, dev,
                        card, pool=None):
    """Data-parallel training and pair sharding on the card (module
    docstring, phase 10), its CPU references from `pool` (own_pool).
    Returns {measurement: number}."""
    import tempfile
    from instaorder_tpu_torch.train import step as ST
    from instaorder_tpu_torch.train import trainer as T

    t0 = time.perf_counter()
    numbers = {}
    n_cards = torch.cuda.device_count()
    torch.cuda.empty_cache()        # the ranks' memory on the same card
    with tempfile.TemporaryDirectory() as root, own_pool(pool) as pool:
        fixture = instaorder_fixture(root)
        ran = []
        # NCCL refuses two ranks on one device: confirmed and recorded
        dup = dp_spawn(torch, nccl_dup_rank, DP_WORLD, f'{root}/dup', {},
                       timeout=NCCL_DUP_TIMEOUT, may_hang=True)
        print(f'  NCCL with {DP_WORLD} ranks on cuda:0: '
              f'{dup[0] if dup else "hung (killed)"}')
        # (a) two gloo ranks on cuda:0
        params, ref = dp_reference(torch, pool, DP_WORLD, f'{root}/ref.pt')
        with quiet():       # the ranks time their steps and all-reduces
            ranks = dp_spawn(torch, dp_rank, DP_WORLD, f'{root}/a', {
                'mesh': ['cuda:0'] * DP_WORLD, 'backend': 'gloo',
                'fixture': fixture, 'xdev': f'{root}/ref.pt', 'flow': True})
        check_dp_ranks(torch, f'(a) world {DP_WORLD} gloo on cuda:0', ranks,
                       ref, params, card)
        ran.append('a')
        numbers.update(step_ms=ranks[0]['step_ms'],
                       pairs=ranks[0]['pairs'] * DP_WORLD,
                       gloo_allreduce_ms=ranks[0]['allreduce_ms'],
                       n_values=ranks[0]['n_values'])
        # (b) NCCL at world 1, and the world-1 step
        with quiet():
            ms1, pairs1, nccl_ms, flat_ms = dp_nccl_world1(torch, T, ST,
                                                           fixture, dev, root)
        numbers.update(step1_ms=ms1, pairs1=pairs1, nccl_allreduce_ms=nccl_ms,
                       nccl_flat_ms=flat_ms)
        ran.append('b')
        # (c) the predictor's mesh on the one card
        dp_predictors(torch, serving, resnet, TPL, wrappers, calib_x, dev,
                      ['cuda:0'] * DP_WORLD, card)
        ran.append('c')
        # (d) two or more cards
        if n_cards >= 2:
            world = min(n_cards, DP_CARDS)
            mesh = [f'cuda:{i}' for i in range(world)]
            dp_cli(fixture, root, world)
            params, ref = dp_reference(torch, pool, world, f'{root}/ref_d.pt')
            ranks = dp_spawn(torch, dp_rank, world, f'{root}/d', {
                'mesh': mesh, 'backend': 'nccl', 'fixture': fixture,
                'xdev': f'{root}/ref_d.pt', 'flow': True})
            check_dp_ranks(torch, f'(d) world {world} NCCL', ranks, ref,
                           params, card)
            numbers.update(nccl_world=world, nccl_step_ms=ranks[0]['step_ms'],
                           nccl_pairs=ranks[0]['pairs'] * world,
                           nccl_world_allreduce_ms=ranks[0]['allreduce_ms'])
            where = dp_predictors(torch, serving, resnet, TPL, wrappers,
                                  calib_x, dev, mesh, card)
            print(f'  (d) kernels by device: {where}')
            ran.append('d')
        else:
            print('  phase 10 (d) did not run: the machine has one card')
    mb = numbers['n_values'] * 4 / 1e6
    print(f'data parallel (a) world {DP_WORLD} gloo, both ranks on cuda:0: '
          f'step {numbers["step_ms"]:.2f} ms (median of {TIMING_REPS} after '
          f'{TIMING_WARMUP}, each rank a fixed batch of '
          f'{numbers["pairs"] // DP_WORLD} pairs) = '
          f'{numbers["pairs"] / numbers["step_ms"] * 1e3:.1f} pairs/s; the '
          f'world-1 step {numbers["step1_ms"]:.2f} ms = '
          f'{numbers["pairs1"] / numbers["step1_ms"] * 1e3:.1f} pairs/s. '
          f'Two ranks share one card here: not a scaling figure ({card})')
    print(f'data parallel all-reduce of the InstaOrderNet_o gradient bucket '
          f'({numbers["n_values"]} f32 values, {mb:.1f} MB; '
          f'parallel/collectives.all_reduce_mean, median of {DP_REPS} after '
          f'1): gloo at world {DP_WORLD} on cuda:0 '
          f'{numbers["gloo_allreduce_ms"]:.2f} ms, NCCL at world 1 '
          f'{numbers["nccl_allreduce_ms"]:.3f} ms, of it a dist.all_reduce '
          f'of one flat bucket of that size {numbers["nccl_flat_ms"]:.3f} '
          f'ms ({card})')
    if 'nccl_world' in numbers:
        w = numbers['nccl_world']
        print(f'data parallel (d) world {w} NCCL on {w} cards: step '
              f'{numbers["nccl_step_ms"]:.2f} ms = '
              f'{numbers["nccl_pairs"] / numbers["nccl_step_ms"] * 1e3:.1f} '
              f'pairs/s; all-reduce {numbers["nccl_world_allreduce_ms"]:.2f}'
              f' ms ({card})')
    numbers['seconds'] = time.perf_counter() - t0
    print(f'data parallel phase: ran {",".join(ran)}; '
          f'{numbers["seconds"]:.1f} s')
    return numbers


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.convert import tree_to
    from instaorder_tpu_torch.device import resolve_device
    from instaorder_tpu_torch.eval import pipeline as TPL
    from instaorder_tpu_torch.models import folding as FO
    from instaorder_tpu_torch.models import resnet
    from instaorder_tpu_torch.models import quantize as Q
    from instaorder_tpu_torch.ops import _build
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops import int8_kernels as IK
    from instaorder_tpu_torch.ops import pairs as P
    from instaorder_tpu_torch.ops import prep_kernels as PK
    from instaorder_tpu_torch.ops import stem_kernels as SK

    dev = resolve_device()
    card = card_line()
    print(card)
    print(f'glibc malloc keeps freed blocks for reuse: {keep_freed_heap()}')
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}')
    print(f'host: os.cpu_count() {os.cpu_count()}, torch.get_num_threads() '
          f'{torch.get_num_threads()}, len(os.sched_getaffinity(0)) '
          f'{len(os.sched_getaffinity(0))}')
    CLOCK.watch()

    with RefPool() as pool:
        # the references that need only seeds and fixtures start now, beside
        # the build and the card's phases: phase 9's longest first
        for job in (*DEPTH_XDEV_REFS.values(), *TRAIN_XDEV_REFS.values(),
                    PCNET_REFS, dp_ref_job(DP_WORLD), LEGACY_REFS):
            pool.submit(*job)
        if torch.cuda.device_count() >= 2:      # phase 10 (d)'s
            pool.submit(*dp_ref_job(min(torch.cuda.device_count(),
                                        DP_CARDS)))
        # ---- 1. build -------------------------------------------------------
        CLOCK.begin('1 build')
        t0 = time.perf_counter()
        _build.library()
        print(f'build: {time.perf_counter() - t0:.2f} s (nvcc '
              f'{_build.BUILD_INFO["seconds"]:.2f} s)')
        print(_build.BUILD_INFO['log'])

        # ---- 2. kernels vs plain at the serving shapes ----------------------
        CLOCK.begin('2 kernels')
        images, masks, bboxes = serving.synthetic_scenes(
            SCENES, HEIGHT, WIDTH, INSTANCES, seed=0)
        sc = serving.upload_scenes(images, masks, bboxes, device=dev)
        pidx = torch.as_tensor(P.all_pair_indices(INSTANCES)[0],
                               dtype=torch.int32, device=dev)
        rois = P.pair_rois(sc[2], pidx).contiguous()
        n_pairs = SCENES * pidx.shape[0]
        results = {}
        x, results[PREP] = phase_prep(torch, PK, (sc[0], sc[1], pidx, rois),
                                      n_pairs)
        results[PREP_F32] = phase_prep_f32(
            torch, PK, serving, (sc[0], sc[1], pidx, rois), x, n_pairs)
        results[RGB] = phase_prep_rgb(torch, PK, sc[0], rois, n_pairs)
        results[RGB32] = phase_prep_rgb_f32(torch, PK, sc[0], rois, n_pairs)
        # the serving model, calibrated on this prepped batch (as bench.py).
        # kaiming init: bench.py's xavier(0.02) trunk quantizes every
        # activation to 0, which would make every comparison vacuous
        t0 = time.perf_counter()
        q, cfg = serving.build_serving_model(0, x, device=dev,
                                             weight_init='kaiming_out')
        params16, cfg16 = serving.build_parity_model(0, device=dev,
                                                     weight_init='kaiming_out')
        # the --dtype f32 model: the same network, folded, left in f32
        params32, _ = serving.build_f32_model(0, device=dev,
                                              weight_init='kaiming_out')
        # the v2 model at compute_dtype=f32: serving-d1's network and
        # calibration, quantized at f32, with its f32 stem kernel weights
        folded, _, scales = serving._calibrated(0, x, dev, 'kaiming_out')
        q32 = Q.quantize_folded_v2(folded, cfg, scales,
                                   compute_dtype=torch.float32)
        FO.add_stem_kernel_weights(q32['conv1'])
        FO.add_f32_block_weights(q32)
        del folded
        torch.cuda.synchronize()
        print(f'build_serving_model + build_parity_model: '
              f'{time.perf_counter() - t0:.2f} s')
        # serving-d2's model is calibrated on its own (3-pass) prep, as the
        # root bench builds each profile's model
        x3 = PK.fused_prep_pairs(sc[0], sc[1], pidx, rois, out_size=OUT,
                                 passes=3)
        q2, _ = serving.build_serving_model(0, x3, device=dev,
                                            weight_init='kaiming_out')
        # the int8c models, each calibrated on its own profile's prep
        q8c, _ = serving.build_int8c_model(0, x, device=dev,
                                           weight_init='kaiming_out')
        q8c2, _ = serving.build_int8c_model(0, x3, device=dev,
                                            weight_init='kaiming_out')
        models = {('serving-d1', 'int8'): q, ('serving-d2', 'int8'): q2,
                  ('parity', 'bf16'): params16, ('serving-d1', 'int8c'): q8c,
                  ('serving-d2', 'int8c'): q8c2,
                  ('serving-d1', 'f32'): params32, ('parity', 'f32'): params32}
        with torch.no_grad():
            phase_trunk(torch, BK, Q, FO, q, x, results)
            phase_trunk_v2_variants(torch, BK, Q, FO, q, x, results)
            # x3 is also the parity path's input at the kernels' shapes
            phase_stem_q8(torch, SK, FO, q2, x3, results)
            phase_trunk_bf16(torch, B16, SK, FO, params16, x3, results)
            # the f32 trunk on the f32 prep (x3's values, not rounded)
            t0 = time.perf_counter()
            x3f = PK.fused_prep_pairs(sc[0], sc[1], pidx, rois, out_size=OUT,
                                      passes=3, out_dtype=torch.float32)
            phase_trunk_f32(torch, B16, SK, FO, params32, x3f, results)
            del x3f
            print(f'f32 kernels vs plain: {time.perf_counter() - t0:.1f} s')
            # the v2 f32 rows on the v2 f32 model's trunk (x in f32)
            t0 = time.perf_counter()
            phase_stem_q8(torch, SK, FO, q32, x, results, f32=True)
            phase_trunk(torch, BK, Q, FO, q32, x.float(), results, f32=True)
            phase_trunk_v2_variants(torch, BK, Q, FO, q32, x.float(), results,
                                    f32=True)
            print(f'v2 f32 kernels vs plain: {time.perf_counter() - t0:.1f} s')
            t0 = time.perf_counter()
            phase_trunk_int8(torch, IK, SK, Q, FO, q8c, x, results, wide=False)
            phase_trunk_int8(torch, IK, SK, Q, FO, q8c2, x3, results,
                             wide=True)
            print(f'int8c kernels vs plain: {time.perf_counter() - t0:.1f} s')

        # ---- 3. the megasteps -----------------------------------------------
        CLOCK.begin('3 megasteps')
        wrappers = {PREP: PK.fused_prep_pairs,
                    STAGE: BK.fused_bottleneck_i8v2_stage,
                    DOWN: BK.fused_bottleneck_i8v2_down_s2,
                    IDEN: BK.fused_bottleneck_i8v2_identity,
                    RGB: PK.fused_prep_rgb,
                    IDEN16: B16.fused_bottleneck,
                    DOWN16: B16.fused_bottleneck_down,
                    STEM: SK.fused_stem,
                    I8: IK.fused_bottleneck_int8,
                    D8: IK.fused_bottleneck_down_int8,
                    STEM8: SK.fused_stem_int8,
                    I8H: IK.fused_bottleneck_int8_hwnc,
                    D8H1: IK.fused_bottleneck_down_int8_hwnc,
                    D8H2: IK.fused_bottleneck_down_s2_int8_hwnc,
                    HWNCP: BK.fused_bottleneck_i8v2_hwncp_stage,
                    DOWN1H: BK.fused_bottleneck_down_i8v2_hwnc,
                    IDENN: BK.fused_bottleneck_i8v2,
                    DOWN1N: BK.fused_bottleneck_down_i8v2,
                    STAGE16: B16.fused_bottleneck_stage,
                    SSTAGE16: B16.fused_bottleneck_stage_stream,
                    HWNC16: B16.fused_bottleneck_hwnc}
        plain_v2 = Q._plain_block_v2

        def counted_plain_v2(*a, **kw):
            counted_plain_v2.launches += 1
            return plain_v2(*a, **kw)
        Q._plain_block_v2 = counted_plain_v2
        counters = dict(wrappers, **{PLAIN_V2: counted_plain_v2})
        launches = {}
        for name, profile, extra, expected in MEGASTEPS:
            prof = serving.resolve_profile(profile,
                                           prep_rgb=extra.get('prep_rgb'),
                                           dtype=extra.get('dtype'))
            kw = dict(out_size=OUT, passes=prof['passes'],
                      directions=prof['directions'], prep_rgb=prof['prep_rgb'],
                      prep_precision=serving.prep_precision_of(profile),
                      use_pallas=extra.get('use_pallas', True))
            model = models[profile, prof['dtype']]

            def reference(few, model=model, kw=kw):
                """(fn, args, kwargs) of the plain path on the CPU."""
                xp = serving.prep_pairs(*sc, pidx, out_size=OUT,
                                        passes=kw['passes'],
                                        prep_rgb=kw['prep_rgb'],
                                        prep_precision=kw['prep_precision'],
                                        dtype=serving.compute_dtype(model)
                                        )[:few].cpu()
                m = tree_to(model, 'cpu')
                use = {'use_pallas': kw['use_pallas']}
                two = kw['directions'] == 2
                if 'cfg_scales' in m:
                    return (Q.apply_folded_int8_siamese if two else
                            Q.apply_folded_int8), (m, cfg, xp), use
                if 's_feat' in m:
                    return (Q.apply_folded_v2_siamese if two else
                            Q.apply_folded_v2), (m, cfg, xp), use
                return (FO.apply_folded_siamese if two else
                        FO.apply_folded), (m, cfg16, xp), dict(
                            use, dtype=serving.compute_dtype(m))

            step = lambda model=model, kw=kw: serving.megastep(
                model, cfg, *sc, pidx, **kw)
            got, logits = phase_megastep(
                torch, name, step, reference, counters, expected, n_pairs,
                card, prof['directions'],
                (MARGIN_PAIRS,) if prof['dtype'] == 'int8' else (), pool,
                bar=F32_LOGIT_BAR if prof['dtype'] == 'f32' else 0.02)
            if prof['dtype'] == 'int8c':
                with torch.no_grad():
                    xp = serving.prep_pairs(
                        *sc, pidx, out_size=OUT, passes=kw['passes'],
                        prep_rgb=kw['prep_rgb'],
                        prep_precision=kw['prep_precision'])
                    check_int8c_same_input(
                        torch, Q, FO, model, cfg, xp, prof['directions'],
                        kw['use_pallas'], logits)
            for k, n in got.items():
                if prof['dtype'] == 'f32' and k in wrappers:
                    k += F32            # the launches of the f32 modes
                if n and k not in launches and k in SOURCES:
                    launches[k] = n
            if name == HWNCS_STEP:
                launches[RUN] = got[STAGE]
            if name == STEMQ8_STEP:
                launches[STEMQ8] = got[STEM]
        with torch.no_grad():
            phase_v2_f32_forwards(torch, serving, Q, q32, cfg, x.float(),
                                  counters, n_pairs, card, launches, pool)

        # ---- 4. the order predictors ----------------------------------------
        CLOCK.begin('4 predictors')
        launches.update(phase_predictors(torch, serving, resnet, TPL,
                                         wrappers, x, dev, card, pool))
        check(set(launches) == set(wrappers) | {RUN, STEMQ8, PREP_F32,
                                                *F32_ROWS, *V2F32_ROWS},
              f'every kernel launched on a main path: {sorted(launches)}')

        # ---- 5. the Tester --------------------------------------------------
        CLOCK.begin('5 tester')
        phase_tester(torch, dev, card, wrappers, pool)

        # ---- 6. training ----------------------------------------------------
        CLOCK.begin('6 training')
        phase_train(torch, dev, card, wrappers, pool)

        # ---- 7. the MiDaS family --------------------------------------------
        CLOCK.begin('7 midas')
        phase_midas(torch, dev, card, wrappers, pool)

        # ---- 8. PCNet-M -----------------------------------------------------
        CLOCK.begin('8 pcnet')
        pcnet = phase_pcnet(torch, dev, card, wrappers, pool)

        # ---- 9. InstaDepthNet training --------------------------------------
        CLOCK.begin('9 depth training')
        phase_depth(torch, dev, card, wrappers, pool)

        # ---- 10. data parallel ----------------------------------------------
        CLOCK.begin('10 data parallel')
        phase_data_parallel(torch, serving, resnet, TPL, wrappers, x, dev,
                            card, pool)

        # ---- 11. the last modules -------------------------------------------
        CLOCK.begin('11 last modules')
        phase_last_modules(torch, dev, card, wrappers, pcnet, pool)

        # ---- 12. the deferred card-vs-CPU checks ----------------------------
        CLOCK.begin('12 deferred checks')
        pool.finish()
        CLOCK.end()

        # ---- 13. report -----------------------------------------------------
        kernels = []
        for name, r in results.items():
            t_bytes = r['bytes'] / H100_BYTES_PER_S * 1e3
            t_ops = r['ops'] / r['ops_rate'] * 1e3
            if 'chain_ms' in r:
                print(f'{name}: kernel {r["ms"]:.4f} ms, plain cuDNN chain of '
                      f'the JAX default route (several calls) '
                      f'{r["chain_ms"]:.4f} ms')
            if name.startswith(STEM):
                unit = ('TOP/s' if r['ops_rate'] == H100_INT8_PER_S
                        else 'TFLOP/s')
                print(f'{name}: kernel {r["ms"]:.4f} ms, '
                      f'{r["ops"] / r["ms"] / 1e9:.2f} {unit} at K = 245 '
                      f'({100 * t_ops / r["ms"]:.1f}% of the {unit} peak)')
            if 'conv_only_ms' in r:
                print(f'{name}: kernel {r["ms"]:.4f} ms, its convolutions '
                      f'alone (bf16 conv2d, channels_last) '
                      f'{r["conv_only_ms"]:.4f} ms')
            if 'tf32_ops' in r:
                # the f32 rows: the least time for f32-accurate work is the
                # 3xTF32 method's on the tensor cores, below the f32 peak's
                t_f32, t_ops = t_ops, r['tf32_ops'] / H100_TF32_PER_S * 1e3
                print(f'{name}: kernel {r["ms"]:.4f} ms; 3xTF32 bound '
                      f'{t_ops:.4f} ms ({100 * t_ops / r["ms"]:.1f}% of it), '
                      f'f32 bound {t_f32:.4f} ms '
                      f'({100 * t_f32 / r["ms"]:.1f}%)')
            if 'floor_ops' in r:
                # the f32 stem: its design's floor, the same method at the K
                # it issues (the row's bound_ms stays at the real K = 245)
                t_k = r['floor_ops'] / H100_TF32_PER_S * 1e3
                print(f'{name}: kernel {r["ms"]:.4f} ms; design floor at its '
                      f'padded K {t_k:.4f} ms ({100 * t_k / r["ms"]:.1f}% of '
                      f'it)')
            kernels.append({
                'name': name, 'route': 'cuda', 'source': SOURCES[name],
                'replaces': REPLACES[name], 'launches': launches[name],
                'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                'plain_ms': r['plain_ms'], 'bound_ms': max(t_bytes, t_ops),
                'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
                'library_ms': None, 'conv_only_ms': r.get('conv_only_ms')})
        print(inventory.coverage_line(results))
        check(not inventory.missing_rows(results),
              'every kernel row of the inventory held against its plain '
              'version')
        print(CLOCK.line())
        print(card)
        print(json.dumps({'kernels': kernels}))
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count()}}))
        return 0


if __name__ == '__main__':
    sys.exit(main())
