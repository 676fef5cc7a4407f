#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (silent_speech_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero and
prints no result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the kernels from silent_speech_tpu_torch/csrc/*.cu with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   serving and training shapes, TF32 off for the plain version; the ROI CNN
   backward (K3) also against the plain version evaluated in float64, and
   twice on the same inputs (bitwise-equal), and K3's recomputed conv3
   means bitwise K1's at the edges of K3's own wave (roi_cnn_bwd_plan),
   constant tie frames among them; the serving modes' ROI CNN
   kernels (K1-bf16, K4 int8, K5 im2col) at N=8192, a ragged N=33, N=1,
   a frame past K4's and K5's waves (their plans) and on all-0 and all-255
   frames (K5 at K1's f32 bars), K4 and K5 on sub-batches (bitwise-equal
   rows), K5's debug stops and K4's check entry (its stops; stage 1 as
   scalar integers, bitwise the same) against their plain versions;
   K1 and K1-bf16 at the edges of the kernel's own wave (roi_cnn_plan: a
   wave, a frame either side, two waves and a frame), twice on the same
   frames and on sub-batches (bitwise-equal rows);
   K2's two kernels each against its own plain version (gru_proj on each
   of its routes, small M and large M, against the matmul and twice
   bitwise, gru_seq over its output against the masked recurrence,
   gru_seq twice bitwise) at B=1, 64, 256 and 1024 (the split tile and
   three tiled ones), D=212 and 384, both directions a launch;
4. the serving path at full width (random weights from a seed): the
   ``predict`` CLI on clips of 5..90 frames, and ``Predictor.predict_batch``
   at B=256, T=32 against the plain path on the card and on the CPU, with
   the kernels' launch counts over that run;
5. the training path at full width: the ``train`` CLI for 10 epochs at
   batch 16, lr 1e-3, on a synthetic corpus (10 words x 8 clips of 20..90
   frames), with the kernels' launch counts over that run, then ``predict``
   on its checkpoint; and one train step (B=16, T=90, no dropout or
   augmentation) through the kernels against the plain path (its ROI CNN
   along K1's route, which may differ from the plain forward's own only at
   near-ties; the loss and gradients also against the plain path's own);
5b. the serving modes: the ``eval-dataset`` CLI with that checkpoint over a
   second synthetic corpus (10 words x 32 clips of 20..90 frames, batch 64)
   in four modes: f32 kernels, bf16, int8 (tiled3_q8) and im2col, with
   each run's launch counts, accuracy, average confidence and clips/s; each
   mode's logits on the whole corpus against the f32 kernels mode (argmax
   equal for every clip, drift under tests/test_bf16_parity.py's 0.15);
6. timings with CUDA events: each kernel, its plain version and, where one
   exists, the PyTorch library call for the same function; each kernel's
   bound; K1 and K1-bf16 at N=8192, 5,760 and 32 with the host's launches
   held out, each beside its bound (the bf16 build at the bf16 rate; the
   f32 build at the f32 FMAs and the tensor cores' 3xTF32 together; a row
   over 100% of its bound fails), and K1 on the official init beside it;
   K3 at N=8192 and 1,440 (the protocol's train step) with the host's
   launches held out, beside its bound at the same rates as K1 f32 (over
   100% fails), and at N=8192 by stage (its check entry's stops); K2 (one bidirectional layer, D=212, T=32) at B=1, 256 and 1024:
   the layer and each of its two kernels with the host's launches held
   out, beside torch.nn.GRU and torch.addmm, with its plan (C, BT, the
   route of Wh) and bounds (the layer and gru_proj at the f32 FMAs and
   3xTF32 together; a time under its bound fails); gru_proj alone at
   D=212 and 384, M=32, 8,192 and 32,768 (B=1, 256 and 1024) and at the
   other shapes the paths give it (M=2,048: the checks' B=64; 5,120: CTC;
   5,760: the sweep; 1,024), on the route it takes, on each route, the
   large route at each tile width and with one TF32 pass (timing stops),
   beside torch.addmm, with its plan (route, tile, blocks); K4 and K5 at
   the sweep's shape (64 x 90 = 5,760 frames) and at N=8192 beside their
   bounds (K5 at K1's, beside K1's time at the same N; K4 at the int8
   rate; over 100% fails), by stage at N=8192 (their stops), K4 with stage
   1 on either route, and the modes' forward at B=64, T=90; serving clips/s
   at B=256 and B=1024 (T=32), p50 latency at B=1; train steps at B=16,
   T=90 and B=256, T=32;
7. a torch.profiler pass over ``predict_batch`` at B=1, 256 and 1024
   (T=32), over each serving mode at B=64, T=90, and over the B=256 train
   step: device time by kernel and copy, and the device's idle share;
8. the GRU probes (silent_speech_tpu_torch/scripts): the recurrence kernel
   with one and two weight sets, K2's one-direction launch and the
   dual-chain kernel against their plain versions at B=1, 33 and 512, T=32,
   D=180 and 384, f32 and bf16_mm, each at its plan's tile (printed);
   their times (the held-stream timer), bounds (each part at the card's
   rate for its type) and cuDNN's layer (a median of LIB_REPS readings) at
   B=512 and B=1, beside P4 K2's layer and P4's function with the
   projection ahead; and the main() of bench_gru,
   proto_gru2, proto_gru3 and proto_gru4 at B=512 and B=1 (5 timed calls a
   variant), with the launch counts over each script's runs;
9. the CNN-front prototypes (silent_speech_tpu_torch/scripts): the parity
   conv1 + pool1 kernel in both layouts against its plain version at
   N=8192 and N=16, on all-0 and all-255 frames, with packed and random
   weights, a second launch and its ablation's ``full`` bitwise the
   kernel, every stop run; at N=8192 with random weights its and the plain
   version's distance from float64, the one-sum control's error and the W_hi-pass control, which must miss the
   bar; each stage of the
   front probe (its ladder also at N just below and above one wave of its
   persistent blocks, one geometry for every rung) and each of K1's
   debug stops against its plain version; K1
   itself within its bar; their times, bounds (the parity kernel's at the
   FMAs and two TF32 passes together, K1's stops' at the FMAs and 3xTF32
   together, over 100% failing) and
   plain versions' times at N=8192, the parity kernel's stops and
   controls; and the main() of proto_parity_cnn, proto_parity_e2e,
   proto_ablate and probe_front at N=8192, with the launch counts over each;
10. the forward rate probes (silent_speech_tpu_torch/scripts): the
   matmul-rate kernel (MR) at bench_fused_cnn's six shapes and small ragged
   ones, the chained-dot kernel (DC) in its four modes at K=384 and 512
   (int8 and int8i also at a partial last sweep of their persistent grid,
   each tile's moments and repeats bitwise, their plan the mirror's),
   and the layout kernel (LP) in its nine bodies, each against its plain
   version (DC in bf16 also product by product, with two controls that
   must fail; LP's product body, 3xTF32, also against the float64
   version, with one TF32 pass as the control that must fail, its copied
   lanes bitwise; its moving bodies also at a step count that leaves
   their persistent blocks a partial last sweep, each bitwise); then the main() of probe_int8, bench_fused_cnn (mxu,
   main and ftile) and mosaic_micro at full size, with the launch counts
   over each, whose rows give the kernels' times, bounds (a row above
   100% of its bound fails), and the plain versions' and library calls'
   times (MR's: one matmul of its stacked operands, the same work; LP's
   product body: its product part, and with the copy the same work; DC's
   int8 and int8i beside the bf16 chain and 14 ``_int_mm`` calls);
   and DC's bf16 kernel in each variant (clusters of 1, 2, 3 and 6
   blocks), each bitwise the checked output, with its plan
   (cluster, stages, shared memory) and time beside the bound; LP's moving
   bodies, cold L2, in turns beside their library call
   (:func:`time_lp_moves`);
11. the backward-dot probes (silent_speech_tpu_torch/scripts): the tt, xp,
   nt, base and nn kernels against their plain versions at small ragged
   shapes (rows 100, m 24, K 104, N 130; dots3's form at 7 steps), all
   five (3xTF32 on the tensor cores) also against the float64
   version, xp bitwise tt there and at dots2's full shapes, all five
   twice on the same full-size inputs (bitwise equal), nt's tail
   rows exact zeros, one TF32 pass outside the float64 bar (the control:
   tt, xp and nn at full size, nt at the small shape and dots1's three,
   base at the small shape, where the bar's derivation says it can refuse
   it), nt's 3-pass stop bitwise nt, the five kernels' launch plans; then
   the main() of proto_bwd_dots, proto_bwd_dots2 and proto_bwd_dots3 at
   full size, with the launch counts over each, whose rows hold each
   kernel against its plain version (the tensor-core kinds also float64)
   at the scripts' shapes and give its time, bound (every kind at
   the f32 FMAs and 3xTF32 together; a row above 100% of it fails), and
   the plain version's and the library call's times (the tensor-core
   kinds also the call that does the same work), and xp / tt at each of
   dots2's m (the transposing stage's cost); tt's mainloop by parts at
   dots1's K=512 (its stops: one TF32 pass, the fragment feed without
   MMAs, the cp.async ring alone) beside torch.matmul; nt at dots1's three
   shapes in three TF32 passes and one, beside ``dy[:Gm] @ w.T``;
12. the CTC family at full width (hidden 192, 3 GRU layers, emb 32, 27
   classes, random weights from the seed; ``check_ctc``): its forward on K1
   and K2 against the plain version at B=64, T=80 (log-probabilities within
   1e-3, the dictionary argmax equal on every clip), one train step at
   B=32, T=80 (K3 at N=2,560, standardize off) against the plain step at
   the official parity's bars; the train-ctc CLI on phase 5's corpus, the
   eval-ctc CLI over phase 5b's 320 clips in the four serving modes (each
   mode's argmax equal to f32's on every clip), predict on a CTC clip, and
   the official train CLI with compute_dtype=bfloat16 and host_data=true
   (bitwise the device-resident run); the CTC train step's time, kernels
   and plain, score_batch clips/s at B=64 against 10 and 1,000 words, the
   device breakdowns of both and of the lattice alone, and K1, K2's three
   layers (beside torch.nn.GRU's three, TF32 off) and K3 at the CTC path's
   shapes beside their bounds;
13. the variant and legacy families (slice 5, :func:`check_variants`):
   the reduced BiGRU (H=64, D=83), the GRU-word classifier (H=128, two
   layers, D=83), the uni-GRU (H=128, D=166 with deltas), the TemporalCNN
   and the quick MLP, random weights from the seed, each saved in its
   reference ``.pt`` schema and served by ``load_predictor`` on clips of
   20-90 frames: the GRU families on K2 (gru_proj and gru_seq launched for
   each clip) against gru_impl='plain' (logits within 1e-3, the same
   argmax; GRU outputs within 1e-4, also at B=64), each family's
   ``predict_features`` p50; the train-reduced, train-unigru and train-mlp
   CLIs for 20 epochs on a corpus of 7 words x 8 clips (K2 in their
   validations), then eval-dataset (its accuracy that of an in-process
   ``evaluate_variant_dataset``) and predict on each checkpoint; K2's
   bidirectional layer at H=64 / D=83 / T=60 and H=128 / D=83 / T=40, B=1
   and 64, beside torch.nn.GRU (packed once, TF32 off, median of 7) and
   torch.addmm;
14. the live camera path (slice 6a, :func:`check_live`): ``infer-live``,
   ``infer-gated`` (sequential, and threaded through the native ring) and
   ``infer-ctc`` at full width (the official ``BiGRUConfig()``, the CTC
   ``CTCTrainConfig()`` width), ``infer-stream`` with the window engine
   (GRU-word, H=128, 2 layers, D=83) and the carry engine (uni-GRU,
   H=128, d_target 180), random weights from the seed, each through the
   CLI with ``sim=240`` (640x480 fake frames, a fake face track) on the
   kernels route and on the plain one: the kernels launched (K1 and K2;
   K2 alone for the window; none for the carry engine), the same labels
   on every clip, logits within 1e-3; the carry engine's per-frame logits
   within 1e-5 of the full scan over the same frames; the batched
   features and ROI crop at B=64, T=32 (2,048 frames) against the host
   frame paths (the crop bitwise but on pixels within 1e-4 of a rounding
   boundary, their count printed); the gated clip's host p50, each
   command's sim frames/s, the batched crop's ms and the host crop's ms a
   frame.

Then one JSON line with the kernels' results, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Needs one CUDA device;
refuses to run without one. Scratch files go under build/chip_smoke/ in the
checkout.

    python3 chip_smoke.py --k2-parent DIR

runs only K2's stack in this checkout and in the checkout at DIR (a parent
commit unpacked by ``git archive``), in turns: the outputs bitwise equal,
the held-stream times side by side (:func:`k2_against_parent`).
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
ROOT = Path(__file__).resolve().parent
# bars: the JAX package's own tests (tests/test_pallas_cnn2.py,
# tests/test_pallas_gru.py, tests/test_model_parity.py)
BAR_CNN_LIVE, BAR_CNN_STD, BAR_GRU, BAR_LOGITS = 2e-4, 2e-3, 1e-4, 1e-3
# K1's f32 build against its plain version, live and standardized: between
# its 3xTF32 split's error and one TF32 pass's
# (tests/test_torch_roi_cnn_tc.py holds the emulated split at least 10x
# inside these bars and one pass outside them)
BAR_K1_LIVE, BAR_K1_STD = 2e-6, 1e-5
# K3: max |d| / max |ref| per gradient tensor (tests/test_fused_train.py;
# tests/test_torch_roi_cnn_bwd_tc.py holds K3's emulated 3xTF32 gradients
# at least 10x inside it and one TF32 pass outside it);
# train step: loss, gradients and post-Adam parameters
# (tests/test_fused_train.py:180-189, tests/test_train.py:94-113)
BAR_K3, BAR_LOSS, BAR_GRAD, BAR_PARAM = 5e-5, 1e-5, 1e-4, 3e-4
# K3 at N=1000 and 8192: two f32 implementations route some near-tied 2x2
# pool windows to different inputs; the f32 plain version itself lies up to
# 2.4e-4 from its float64 evaluation there (PERF.md, section 6)
BAR_K3_ROUTING = 5e-4
# K3 differentiates the branch of K1's forward (the route its check entry
# reports): it is held at BAR_K3 to the plain version along that route, and
# the route may differ from the float64 plain forward's own only at
# near-ties: a pool window's max minus the value taken, or a ReLU input's
# |value| where the two disagree on its sign, under this share of the
# layer's largest magnitude in the frame (K1's f32 error is about 1e-6 of
# it; a window routed to another element shows a gap of the layer's scale)
ROUTE_TOL = 1e-5
# the serving modes' ROI CNN kernels against their plain versions: bf16
# differs where an f32 sum, taken in another order, crosses a bf16 rounding
# boundary (one bf16 step of one activation, about 1e-6 of the output); on
# a constant frame every interior position computes the same sum, so one
# crossing moves a whole map by one bf16 step (2^-8 of it: up to about 1e-3
# of the output), hence the second bar, for constant frames only; int8 is
# bitwise its plain version up to the last ReLU, so only the mean and the
# fc reassociate (a requantization level moved by one f32 bit would show as
# about 1e-4); im2col computes K1's function as 3xTF32 (K1's f32 bars,
# BAR_K1_LIVE / BAR_K1_STD: tests/test_torch_roi_cnn_im2col_tc.py holds its
# emulated split at least 10x inside them and one TF32 pass outside them)
BAR_BF16, BAR_BF16_CONST, BAR_Q8 = 1e-4, 2e-3, 1e-6
LOGIT_TOL = 0.15  # the serving modes vs f32 (tests/test_bf16_parity.py)
B_SERVE, T_SERVE = 256, 32
B_TRAIN, T_TRAIN = 16, 90  # the reference protocol (core/config.py)
TRAIN_EPOCHS, TRAIN_LR = 10, 1e-3
B_SWEEP = 64  # eval-dataset's batch; clips pad to the checkpoint's max_t 90
K2_B = (1, B_SERVE, 1024)  # K2's timings: live, and two serving batches
# the serving modes: Predictor knobs and the ROI CNN kernel each runs
MODES = {"f32": ({}, "roi_cnn"),
         "bf16": ({"compute_dtype": "bfloat16"}, "roi_cnn_bf16"),
         "q8": ({"roi_variant": "tiled3_q8"}, "roi_cnn_q8"),
         "im2col": ({"roi_variant": "im2col"}, "roi_cnn_im2col")}
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): f32 on
# the CUDA cores, bf16 and int8 on the tensor cores, and HBM bandwidth
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
PEAK_BF16_FLOPS, PEAK_INT8_OPS = 989e12, 1979e12
PEAK_TF32_FLOPS = 495e12
# multiply-adds per frame: the ROI CNN forward (convs + fc at emb=32) and
# what K3 adds to recompute it (fc and d feat, conv3 weight grads and
# transposed conv, conv2 and conv1 grads over the routed cells only)
CNN_FWD_MACS = 48 * 96 * 8 * 9 + 24 * 48 * 16 * 8 * 9 + 12 * 24 * 24 * 16 * 9
CNN_BWD_MACS = (2 * 24 * 16 * 9 * 288 + 2 * 16 * 8 * 9 * 288
                + 8 * 9 * 24 * 48)
# the GRU probes (silent_speech_tpu_torch/scripts): the JAX scripts' width
PROBE_H, PROBE_T, PROBE_D, PROBE_B = 192, 32, (180, 384), (1, 33, 512)
PROBE_SCRIPTS = ("bench_gru", "proto_gru2", "proto_gru3", "proto_gru4")
PROBE_ITERS = 5
# cuDNN's layer beside the probes: its median of LIB_REPS readings, after
# LIB_WARM_S seconds of calls (one reading moved 0.68-1.25 ms at B=512)
LIB_REPS, LIB_WARM_S = 7, 0.5
# kernel: (source, the TPU kernel's pallas_call, the script that drives
# it, the launch count it adds to); proto_gru3's kernel is K2's launch
PROBE_KERNELS = {
    "gru_kstep": ("gru_proto.cu", "scripts/proto_gru2.py:100", "proto_gru2",
                  "gru_kstep"),
    "gru_kstep_2w": ("gru_proto.cu", "scripts/proto_gru2.py:229",
                     "proto_gru2", "gru_kstep_2w"),
    "gru_fusedproj": ("gru_seq.cu", "scripts/proto_gru3.py:120",
                      "proto_gru3", "gru_seq"),
    "gru_dual": ("gru_proto.cu", "scripts/proto_gru4.py:143", "proto_gru4",
                 "gru_dual"),
}
# bf16_mm, kernel vs plain: both round the same operands, but sum the f32
# products in another order, so an h within one f32 rounding of a bf16
# rounding boundary rounds one bf16 step (2^-8 |h|, |h| < 1) apart in the
# two; that moves each term w h of the next step's product by at most
# max|Wh| * 2^-8 (about 3e-4 for U(+-1/sqrt(192)) weights) and the gates
# pass at most that on to h'; a few such flips in one row stay under 2e-3
BAR_GRU_BF16 = 2e-3
# a bf16 row of the scripts against the f32 scan over 2 layers: bf16
# rounding of every operand (the JAX scripts' own gap is 1.65e-4 / 9.0e-4
# at B=3, H=16); a sanity bar on values of |h| < 1
BAR_PROBE_BF16_ROW = 5e-2

# the CNN-front prototypes: the scripts' problem, N=8192 frames; the bars
# of the JAX scripts (f32 1e-4 with packed weights, proto_parity_cnn.py:223;
# random unpacked weights, outputs in the thousands: max|err| / max|ref| <=
# 1e-6); a debug stop's per-frame moments, f32 sums of 4,608 to 10,400
# terms against float64: 1e-5 of each moment's sum of absolute terms
FRONT_N, FRONT_ITERS = 8192, 10
FRONT_SCRIPTS = ("proto_parity_cnn", "proto_parity_e2e", "proto_ablate",
                 "probe_front")
BAR_PARITY, BAR_PARITY_REL, BAR_STOP_REL = 1e-4, 1e-6, 1e-5
# kernel: (source, the TPU kernel's pallas_call, the script whose run
# counts it)
FRONT_KERNELS = {
    "conv1pool1_parity": ("roi_parity.cu", "scripts/proto_parity_cnn.py:144",
                          "proto_parity_cnn"),
    "conv1pool1": ("roi_parity.cu", "scripts/proto_parity_e2e.py:91",
                   "proto_parity_e2e"),
    "parity_ablate": ("roi_parity.cu", "scripts/proto_ablate.py:91",
                      "proto_ablate"),
    "roi_front_probe": ("roi_front_probe.cu", "scripts/probe_front.py:127",
                        "probe_front"),
    "roi_cnn_debug": ("roi_cnn.cu",
                      "silent_speech_tpu/ops/pallas_cnn2.py:1018 "
                      "(_DEBUG_STOP_AFTER, :78)", "probe_front"),
}
# multiply-adds a frame of the parity kernel's function for any WE/WO: 12
# rows x 4 classes x 3 tiles x 2 matrices x 102 x 128 (the TPU kernel's dot
# runs 104 patch rows, but rows 102 and 103 of the patch are zero and add
# nothing; csrc/roi_parity.cu sums r < 102)
PARITY_MACS = 12 * 4 * 3 * 2 * 102 * 128
# the rate of the parity function's f32 work: the patch is uint8 values,
# exact in TF32, so two TF32 passes (patch x W_hi, patch x W_lo) carry
# 3xTF32's accuracy; on the FMAs and the tensor cores together
PARITY_PEAK = PEAK_F32_FLOPS + PEAK_TF32_FLOPS / 2
# multiply-adds a frame up to each of K1's debug stops
STOP_MACS = {"load": 0, "norm": 0, "conv1": 48 * 96 * 8 * 9,
             "conv2": 48 * 96 * 8 * 9 + 24 * 48 * 16 * 8 * 9,
             "conv3": CNN_FWD_MACS}
# how K1 (csrc/roi_cnn.cu) splits its work between the card's units; a
# note beside its rows, not their bound
K1_SPLIT = {False: "conv1 and the fc on the f32 FMAs, conv2 and conv3 on "
                   "the tensor cores as 3xTF32",
            True: "conv1 and the fc on the f32 FMAs, conv2 and conv3 on "
                  "the tensor cores in bf16"}

# the forward rate probes (silent_speech_tpu_torch/scripts): the JAX
# scripts' problems, nothing cut; kernel: (source, the TPU kernel's
# pallas_call, the script whose run counts and times it, the row the
# kernels line shows first)
RATE_SCRIPTS = ("probe_int8", "bench_fused_cnn", "mosaic_micro")
RATE_KERNELS = {
    "mm_rate": ("mm_rate.cu", "scripts/bench_fused_cnn.py:78",
                "bench_fused_cnn", "1024x1024x1024"),
    "dot_chain": ("dot_chain.cu", "scripts/probe_int8.py:97", "probe_int8",
                  "int8_k512"),
    "layout_micro": ("layout_micro.cu", "scripts/mosaic_micro.py:34",
                     "mosaic_micro", "copy"),
}
RATE_ITERS = 5
# the rate probes' small shapes: MR at reps 9 (every r % 8) and grid 2,
# ragged against the 64-row tile and the 64- or 128-column one; DC at 3
# steps; LP at 2 steps
RATE_SMALL_MM = ((16, 24, 16), (70, 104, 130), (192, 104, 128))

# the backward-dot probes (silent_speech_tpu_torch/scripts): the JAX
# scripts' problems, nothing cut; kernel: (the TPU kernels' pallas_calls it
# replaces, the script and row the kernels line shows first); the rows of
# each kind a kernel runs
BWD_SCRIPTS = ("proto_bwd_dots", "proto_bwd_dots2", "proto_bwd_dots3")
BWD_KERNELS = {
    "bwd_dot_tt": ("scripts/proto_bwd_dots.py:51 (run_tt); "
                   "scripts/proto_bwd_dots2.py:60 (_k_tt); "
                   "scripts/proto_bwd_dots3.py:44 (_k_tt)",
                   ("proto_bwd_dots", "tt_384x512x256")),
    "bwd_dot_nt": ("scripts/proto_bwd_dots.py:71 (run_nt)",
                   ("proto_bwd_dots", "nt_384x512x256")),
    "bwd_dot_base": ("scripts/proto_bwd_dots2.py:60 (_k_base)",
                     ("proto_bwd_dots2", "base_m384")),
    "bwd_dot_nn": ("scripts/proto_bwd_dots3.py:44 (_k_nn)",
                   ("proto_bwd_dots3", "nn_384x512x256")),
    "bwd_dot_xp": ("scripts/proto_bwd_dots2.py:60 (_k_xp)",
                   ("proto_bwd_dots2", "xp_m384")),
}
BWD_KIND_KERNEL = {"tt": "bwd_dot_tt", "nt": "bwd_dot_nt",
                   "base": "bwd_dot_base", "nn": "bwd_dot_nn",
                   "xp": "bwd_dot_xp"}
BWD_SMALL = (100, 24, 104, 130)  # rows, m, K, N: ragged everywhere


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor,
                bar: float) -> float:
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got.double() - ref.double()).abs().max().item()
    print(f"  {name}: max_abs_err {err:.3e} (bar {bar:g})")
    if not err <= bar:
        fail(f"{name}: max_abs_err {err:.3e} over the bar {bar:g}")
    return err


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS
             ) -> tuple[float, str]:
    """The least time for the work on the card: the larger of the
    operations over the peak rate for their type (f32 unless given) and the
    bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_bound(N: int, macs: int, nbytes: float,
             bf16: bool = False) -> tuple[float, str]:
    """K1's least time for N frames of ``macs`` multiply-adds a frame,
    whichever unit does them. bf16 build: every product at the bf16 rate
    (its operands are bf16). f32 build: the work split between the f32
    FMAs and the tensor cores as 3xTF32 (three TF32 products a
    multiply-add) so that both finish together, i.e. at the sum of the two
    rates; the kernel's own split (K1_SPLIT) can only take longer."""
    return bound_ms(2 * N * macs, nbytes, PEAK_BF16_FLOPS if bf16 else
                    PEAK_F32_FLOPS + PEAK_TF32_FLOPS / 3)


def tc_bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of f32 work that may run on the f32 FMAs and the
    tensor cores' 3xTF32 together (67 + 495/3 = 232 TFLOP/s), or of its
    bytes."""
    return bound_ms(flops, nbytes, PEAK_F32_FLOPS + PEAK_TF32_FLOPS / 3)


def proj_bound(M: int, K: int, N: int) -> tuple[float, str]:
    """gru_proj's least time for x (M, K) @ Wi (K, N) + bi: its multiply-
    adds at the FMAs and 3xTF32 together (:func:`tc_bound`; its large
    route runs them as 3xTF32), or x, Wi and bi read once and xp written
    once."""
    return tc_bound(2 * M * K * N, 4 * (M * K + K * N + N + M * N))


def check_bound(name: str, ms: float, bound: float) -> float:
    """The share of its bound a row reaches; over 100% fails (the kernel
    did less work than the function needs)."""
    share = bound / ms
    if share > 1.0:
        fail(f"{name}: {ms:.4f} ms is {share:.1%} of its bound {bound:.4f} "
             "ms: it did less work than the function needs")
    return share


def k3_parts(flat: torch.Tensor, emb: int) -> dict:
    """A flat CNN weight (or gradient) vector split per parameter tensor."""
    sizes = [("conv0.w", 72), ("conv0.b", 8), ("conv1.w", 1152),
             ("conv1.b", 16), ("conv2.w", 3456), ("conv2.b", 24),
             ("fc.w", 24 * emb), ("fc.b", emb)]
    out, o = {}, 0
    for name, n in sizes:
        out[name] = flat[o:o + n]
        o += n
    return out


def rel_errs(got: torch.Tensor, ref: torch.Tensor, emb: int) -> dict:
    """max |got - ref| / max |ref| for each parameter tensor."""
    g, r = k3_parts(got.double(), emb), k3_parts(ref.double(), emb)
    return {k: ((g[k] - r[k]).abs().max() / r[k].abs().max()).item()
            for k in g}


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_breakdown(fn, calls: int = 3) -> dict:
    """Profile ``calls`` calls of ``fn`` (after warm-up) with torch.profiler.

    Returns the host wall ms per call, device ms per call by category
    (copies by direction, the port's two kernels, other kernels), the
    device's busy ms (the union of its events' intervals) and its idle
    share of the wall; ``None`` for the device numbers when the profiler
    recorded no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat: dict[str, float] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.name
        if name.startswith("Memcpy"):
            cat = "memcpy " + name.split()[1]
        elif "roi_cnn_bwd" in name:
            cat = "K3 roi_cnn_bwd"
        elif "roi_cnn_q8" in name:
            cat = "K4 roi_cnn_q8"
        elif "roi_cnn_im2col" in name:
            cat = "K5 roi_cnn_im2col"
        elif "roi_cnn_kernel" in name and "bfloat16" in name:
            cat = "K1-bf16 roi_cnn_bf16"
        elif "roi_cnn_kernel" in name:
            cat = "K1 roi_cnn"
        elif "gru_seq" in name:
            cat = "K2 gru_seq"
        elif "gru_proj" in name:
            cat = "K2 gru_proj"
        elif name.startswith("Memset"):
            cat = "memset"
        else:
            cat = "other kernels"
        start, end = ev.time_range.start, ev.time_range.end
        by_cat[cat] = by_cat.get(cat, 0.0) + (end - start) / 1e3 / calls
        spans.append((start, end))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    busy_ms = busy_us / 1e3 / calls if spans else None
    return {"wall_ms": wall_ms / calls, "busy_ms": busy_ms,
            "idle_share": None if busy_ms is None
            else 1.0 - busy_ms / (wall_ms / calls),
            "device_ms": by_cat or None}


def plain_cnn_grads(roi, dE, p_cnn, standardize, dtype, route=None):
    """The plain version's weight gradients of sum(out * dE), autograd
    through the plain ROI CNN in ``dtype`` (TF32 off), or along ``route``
    (cuda_cnn_check.roi_cnn_plain_routed), as a flat vector in the
    kernels' layout."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_cnn, cuda_cnn_check

    leaves = {k: {n: t.detach().to(dtype).requires_grad_(True)
                  for n, t in v.items()} for k, v in p_cnn.items()}
    with full_f32():
        out = (cuda_cnn.roi_cnn_train_plain(roi, leaves, standardize)
               if route is None else
               cuda_cnn_check.roi_cnn_plain_routed(roi, leaves, standardize,
                                                   route))
        flat_leaves = [t for v in leaves.values() for t in v.values()]
        grads = iter(torch.autograd.grad(out, flat_leaves, dE.to(dtype)))
    return cuda_cnn.flat_weights({k: {n: next(grads) for n in v}
                                  for k, v in leaves.items()})


def route_check(label: str, roi, p_cnn, standardize, route) -> str:
    """Where K1's route differs from the float64 plain forward's own: a
    summary line; fails unless every difference is a near-tie (a gap under
    ROUTE_TOL of the layer's largest magnitude in the frame) and none lies
    at an exact tie (where the first max, and ReLU'(0) = 0, decide)."""
    from silent_speech_tpu_torch.ops import cuda_cnn_check

    p64 = {k: {n: t.double() for n, t in v.items()} for k, v in p_cnn.items()}
    gaps = cuda_cnn_check.route_gaps(roi, p64, standardize, route)
    text = ("K1's route differs from the f64 plain forward's at " + ", ".join(
        f"{k} {g.diffs} (largest gap {g.gap:.1e}, {g.at_ties} at exact ties)"
        for k, g in gaps.items()) + f" (bar {ROUTE_TOL:g}, none at ties)")
    if not cuda_cnn_check.near_ties_only(gaps, ROUTE_TOL):
        fail(f"{label}: {text}")
    return text


def check_k3(p_cnn, flat, gen, dev) -> tuple[float, float]:
    """K3 against the plain version; returns (max abs, max rel) error
    against the f32 plain version over the cases. Raises on a failure.

    On the JAX test's inputs (random frames with the constant tie frames)
    K3 must be within BAR_K3 of the f32 plain version. At N=1000 and 8192,
    where two f32 implementations route some near-tied pool windows
    differently, it must be within BAR_K3_ROUTING of both the f32 plain
    version and its float64 evaluation. In every case K3 must also be
    within BAR_K3 of the f32 plain version along the route K3's check entry
    reports (K1's forward branch), and that route must differ from the
    float64 plain forward's own only at near-ties (gaps under ROUTE_TOL)
    and never at an exact tie. Then K3's recompute against K1: the conv3
    means K3's check entry writes must be bitwise K1's (emb=24 identity
    fc) on random frames with the constant tie frames, standardize off and
    on, N a frame either side of K3's wave."""
    from silent_speech_tpu_torch.ops import cuda_cnn, cuda_cnn_check

    emb = p_cnn["fc"]["b"].shape[0]
    rand = lambda n: torch.randint(0, 256, (n, 48, 96), generator=gen,
                                   dtype=torch.uint8)
    const = lambda vals: torch.tensor(vals, dtype=torch.uint8)[
        :, None, None].expand(len(vals), 48, 96)
    cases = [(N, std, rand(N), False) for N in (B_SERVE * T_SERVE, 1000)
             for std in (False, True)]
    # every 2x2 window of a constant frame is an exact tie; under
    # standardize only 0 and 255 standardize exactly (another level's mean
    # rounds in a summation-order-dependent way, magnified by the 1e-6 std
    # floor)
    cases += [(14, False, torch.cat([rand(10), const([0, 37, 128, 255])]),
               True),
              (12, True, torch.cat([rand(10), const([0, 255])]), True)]
    max_abs = max_rel = 0.0
    for N, std, roi, strict in cases:
        roi = roi.contiguous().to(dev)
        dE = torch.randn(N, emb, generator=gen).to(dev)
        got = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat, standardize=std)
        again = cuda_cnn.roi_cnn_weight_grads(roi, dE, flat, standardize=std)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"roi_cnn_bwd N={N}: non-finite gradients")
        if not torch.equal(got, again):
            fail(f"roi_cnn_bwd N={N}: two launches differ")
        ref32 = plain_cnn_grads(roi, dE, p_cnn, std, torch.float32)
        ref64 = plain_cnn_grads(roi, dE, p_cnn, std, torch.float64)
        e_k32 = rel_errs(got, ref32, emb)
        e_k64 = rel_errs(got, ref64, emb)
        e_p64 = rel_errs(ref32, ref64, emb)
        max_abs = max(max_abs, (got - ref32).abs().max().item())
        max_rel = max(max_rel, max(e_k32.values()))
        label = (f"roi_cnn_bwd N={N} standardize={std}"
                 f"{' (tie frames)' if strict else ''}")
        print(f"  {label}: rel err K3 vs plain f32 / K3 vs f64 / plain f32 "
              f"vs f64 (bar {BAR_K3 if strict else BAR_K3_ROUTING:g}); two "
              f"launches bitwise-equal:")
        print("    " + ", ".join(f"{k} {e_k32[k]:.1e}/{e_k64[k]:.1e}/"
                                 f"{e_p64[k]:.1e}" for k in e_k32))
        for k in e_k32:
            ok = (e_k32[k] < BAR_K3 if strict else
                  max(e_k32[k], e_k64[k]) < BAR_K3_ROUTING)
            if not ok:
                fail(f"{label} {k}: rel err {e_k32[k]:.2e} vs plain, "
                     f"{e_k64[k]:.2e} vs f64 (plain f32 {e_p64[k]:.2e})")
        again, _, route = cuda_cnn_check.roi_cnn_bwd_check(
            roi, dE, flat, standardize=std)
        if not torch.equal(again, got):
            fail(f"{label}: the check entry's gradients differ")
        e_r = rel_errs(got, plain_cnn_grads(roi, dE, p_cnn, std,
                                            torch.float32, route), emb)
        gaps = route_check(label, roi, p_cnn, std, route)
        print(f"    along K1's route (bar {BAR_K3:g}): " + ", ".join(
            f"{k} {v:.1e}" for k, v in e_r.items()) + f"; {gaps}")
        bad = [k for k, v in e_r.items() if not v < BAR_K3]
        if bad:
            fail(f"{label}: rel err along K1's route over {BAR_K3:g} for "
                 f"{bad}: {e_r}")
    pl = cuda_cnn.bwd_plan()
    print(f"  roi_cnn_bwd: {pl.threads} threads and {pl.smem} B of shared "
          f"memory a block, {pl.blocks_per_sm} blocks an SM on {pl.sms} SMs: "
          f"a wave of {pl.wave} blocks (roi_cnn_bwd_plan)")
    eye = dict(p_cnn, fc={"w": torch.eye(24, device=dev),
                          "b": torch.zeros(24, device=dev)})
    flat24 = cuda_cnn.flat_weights(eye)
    for N in (pl.wave - 1, pl.wave + 1):
        roi = torch.cat([rand(N - 4), const([0, 37, 128, 255])]).to(dev)
        for std in (False, True):
            _, feat, _ = cuda_cnn_check.roi_cnn_bwd_check(
                roi, torch.randn(N, 24, generator=gen).to(dev), flat24,
                standardize=std)
            k1 = cuda_cnn.roi_cnn_fused(roi, eye, standardize=std,
                                        impl="kernel", flat=flat24)
            torch.cuda.synchronize()
            bad = (feat != k1).any(dim=1)
            if bad.any():
                fail(f"roi_cnn_bwd N={N} standardize={std}: the recomputed "
                     f"conv3 means differ from K1's on {int(bad.sum())} of "
                     f"{N} frames (max |d| "
                     f"{(feat - k1).abs().max().item():.3e})")
            print(f"  roi_cnn_bwd N={N} standardize={std}: the recomputed "
                  "conv3 means are bitwise K1's on every frame (4 of them "
                  "constant tie frames)")
    return max_abs, max_rel


def check_bf16(name: str, got: torch.Tensor, ref: torch.Tensor,
               roi: torch.Tensor) -> float:
    """check_close of the bf16 kernel: BAR_BF16 on the frames that vary,
    BAR_BF16_CONST on the constant ones."""
    flat = roi.reshape(roi.shape[0], -1)
    const = flat.amin(1) == flat.amax(1)
    err = 0.0
    for sel, what, bar in ((~const, "", BAR_BF16),
                           (const, " (constant frames)", BAR_BF16_CONST)):
        if sel.any():
            err = max(err, check_close(name + what, got[sel], ref[sel], bar))
    return err


def mode_packs(p_cnn: dict) -> dict:
    """The serving modes' ROI CNN weights in their kernels' layouts, by
    kernel name."""
    from silent_speech_tpu_torch.models.bigru import ROI_PACKS

    return {name: ROI_PACKS[name](p_cnn)
            for name in ("roi_cnn_bf16", "roi_cnn_q8", "roi_cnn_im2col")}


def check_serving_kernels(p_cnn, packs, gen, dev) -> dict:
    """K1-bf16, K4 and K5 against their plain versions (TF32 off) at
    N=8192, on a ragged N=33 with frames of 0 and 255, at N=1, at one frame
    past K4's and K5's waves (cuda_cnn_q8.plan, cuda_cnn_im2col.plan) and
    on constant frames only; with and without the standardization, except
    K4 (serving only); K5 within K1's f32 bars. Then K4 and K5 on
    sub-batches of 33 frames and of two K5 waves and a frame: each row
    bitwise the row of the whole batch; K5's debug stops and K4's check
    entry (its stops, and stage 1 as scalar integers, bitwise the same)
    against their plain versions. Returns each kernel's largest error;
    raises on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import (cuda_cnn, cuda_cnn_im2col,
                                             cuda_cnn_q8)

    rand = lambda n: torch.randint(0, 256, (n, 48, 96), generator=gen,
                                   dtype=torch.uint8)
    const = lambda vals: torch.tensor(vals, dtype=torch.uint8)[
        :, None, None].expand(len(vals), 48, 96)
    plans = {"roi_cnn_q8": cuda_cnn_q8.plan(),
             "roi_cnn_im2col": cuda_cnn_im2col.plan()}
    for name, pl in plans.items():
        print(f"  {name}: {pl.threads} threads and {pl.smem} B of shared "
              f"memory a block, {pl.blocks_per_sm} blocks an SM on "
              f"{pl.sms} SMs: a wave of {pl.wave} blocks")
    wave = max(pl.wave for pl in plans.values())
    cases = [("N=8192", rand(B_SERVE * T_SERVE)),
             ("N=33 (frames 0, 255 at the end)",
              torch.cat([rand(31), const([0, 255])])),
             ("N=1", rand(1)), (f"N={wave + 1} (a wave and a frame)",
                                rand(wave + 1)),
             ("N=4 constant 0, 0, 255, 255", const([0, 0, 255, 255]))]
    errs = {"roi_cnn_bf16": 0.0, "roi_cnn_q8": 0.0, "roi_cnn_im2col": 0.0}
    for label, roi in cases:
        roi = roi.contiguous().to(dev)
        for std in (False, True):
            got = cuda_cnn.roi_cnn_bf16(roi, p_cnn, standardize=std,
                                        impl="kernel",
                                        flat=packs["roi_cnn_bf16"])
            with full_f32():
                ref = cuda_cnn.roi_cnn_bf16_plain(roi, p_cnn, std)
            errs["roi_cnn_bf16"] = max(errs["roi_cnn_bf16"], check_bf16(
                f"roi_cnn_bf16 {label} standardize={std}", got, ref, roi))
            got = cuda_cnn_im2col.roi_cnn_im2col(
                roi, p_cnn, standardize=std, impl="kernel",
                packed=packs["roi_cnn_im2col"])
            with full_f32():
                ref = cuda_cnn.roi_cnn_plain(roi, p_cnn, std)
            errs["roi_cnn_im2col"] = max(errs["roi_cnn_im2col"], check_close(
                f"roi_cnn_im2col {label} standardize={std}", got, ref,
                BAR_K1_STD if std else BAR_K1_LIVE))
        got = cuda_cnn_q8.roi_cnn_q8(roi, p_cnn, impl="kernel",
                                     packed=packs["roi_cnn_q8"])
        ref = cuda_cnn_q8.roi_cnn_q8_plain(roi, packs["roi_cnn_q8"])
        errs["roi_cnn_q8"] = max(errs["roi_cnn_q8"], check_close(
            f"roi_cnn_q8 {label}", got, ref, BAR_Q8))
    w = plans["roi_cnn_im2col"].wave
    roi = torch.cat([rand(31), const([0, 255]), rand(2 * w - 32)]).to(dev)
    calls = {"roi_cnn_q8": lambda r, std: cuda_cnn_q8.roi_cnn_q8(
                 r, p_cnn, impl="kernel", packed=packs["roi_cnn_q8"]),
             "roi_cnn_im2col": lambda r, std: cuda_cnn_im2col.roi_cnn_im2col(
                 r, p_cnn, standardize=std, impl="kernel",
                 packed=packs["roi_cnn_im2col"])}
    for name, call in calls.items():
        for std in (False, True) if name == "roi_cnn_im2col" else (False,):
            for n in (33, 2 * w + 1):
                whole = call(roi[:n], std)
                for lo, hi in ((0, 1), (5, 6), (3, 17), (20, 33), (31, 33),
                               (n - 3, n)):
                    if not torch.equal(call(roi[lo:hi].contiguous(), std),
                                       whole[lo:hi]):
                        fail(f"{name} standardize={std}: frames {lo}:{hi} "
                             f"alone differ from the same frames in a batch "
                             f"of {n}")
        print(f"  {name}: frames 0:1, 5:6, 3:17, 20:33, 31:33 and the last "
              f"three alone are bitwise the same frames in batches of 33 "
              f"and {2 * w + 1}")
    # the stops: moments of each stage, within BAR_STOP_REL of each
    # moment's sum of |terms|
    r = roi[:40].contiguous()
    q = packs["roi_cnn_q8"]
    stops = [("roi_cnn_im2col", stop, std,
              lambda stop=stop, std=std: cuda_cnn_im2col.roi_cnn_im2col(
                  r, p_cnn, standardize=std, impl="kernel",
                  packed=packs["roi_cnn_im2col"], debug_stop=stop),
              lambda stop=stop, std=std, a=False: cuda_cnn.roi_cnn_debug_plain(
                  r, p_cnn, std, stop, absolute=a))
             for stop in cuda_cnn.DEBUG_STOPS for std in (False, True)]
    stops += [("roi_cnn_q8", stop, False,
               lambda stop=stop: cuda_cnn_q8.roi_cnn_q8_entry(
                   r, p_cnn, q, stop=stop),
               lambda stop=stop, std=False, a=False:
               cuda_cnn_q8.roi_cnn_q8_debug_plain(r, q, stop, absolute=a))
              for stop in cuda_cnn_q8.STOPS]
    for name, stop, std, kfn, pfn in stops:
        got = kfn()
        with full_f32():
            ref, bar = pfn(), BAR_STOP_REL * pfn(a=True)
        err = (got - ref).abs()
        if not torch.isfinite(got).all() or (err > bar).any():
            fail(f"{name} stop={stop} standardize={std}: max abs err "
                 f"{err.max().item():.3e} off its plain version")
    print(f"  roi_cnn_im2col debug stops {tuple(cuda_cnn.DEBUG_STOPS)} and "
          f"roi_cnn_q8 stops {tuple(cuda_cnn_q8.STOPS)} within "
          f"{BAR_STOP_REL:g} of each moment's sum of |terms|")
    for n in (33, 2 * w + 1):
        if not torch.equal(cuda_cnn_q8.roi_cnn_q8_entry(roi[:n], p_cnn, q),
                           calls["roi_cnn_q8"](roi[:n], False)):
            fail(f"roi_cnn_q8 check entry N={n}: not bitwise the serving "
                 "kernel")
    print("  roi_cnn_q8 check entry without a stop: bitwise the serving "
          "kernel")
    return errs


def check_k1(p_cnn, flat, packs, gen, dev) -> dict:
    """K1 and K1-bf16 (csrc/roi_cnn.cu: persistent blocks, conv2 and conv3
    on the tensor cores) against their plain versions (TF32 off; f32 within
    BAR_K1_LIVE / BAR_K1_STD, which one TF32 pass would miss) at the
    edges of the kernel's own wave (roi_cnn_plan: a wave, a frame either
    side of it, two waves and a frame), standardize off and on; then
    bitwise: two launches on two waves and a frame are equal, and frames
    0:1, 5:6, 3:17, 31:33 and the last three launched alone equal the same
    rows of that batch (other blocks, at other steps of their walk, took
    them there). Returns each build's largest error; raises on a
    failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_cnn

    builds = {
        "roi_cnn": (lambda r, std: cuda_cnn.roi_cnn_fused(
            r, p_cnn, standardize=std, impl="kernel", flat=flat),
            cuda_cnn.roi_cnn_plain, False),
        "roi_cnn_bf16": (lambda r, std: cuda_cnn.roi_cnn_bf16(
            r, p_cnn, standardize=std, impl="kernel",
            flat=packs["roi_cnn_bf16"]), cuda_cnn.roi_cnn_bf16_plain, True)}
    errs = {}
    for name, (kfn, pfn, bf16) in builds.items():
        pl = cuda_cnn.plan(bf16=bf16)
        w = pl.wave
        print(f"  {name}: {pl.threads} threads and {pl.smem} B of shared "
              f"memory a block, {pl.blocks_per_sm} blocks an SM on "
              f"{pl.sms} SMs: a wave of {w} blocks (roi_cnn_plan)")
        roi = torch.randint(0, 256, (2 * w + 1, 48, 96), generator=gen,
                            dtype=torch.uint8)
        roi[32] = 255  # a constant frame among the first 33
        roi = roi.to(dev)
        err = 0.0
        for N in (w - 1, w, w + 1, 2 * w + 1):
            for std in (False, True):
                got = kfn(roi[:N], std)
                with full_f32():
                    ref = pfn(roi[:N], p_cnn, std)
                label = f"{name} N={N} standardize={std}"
                err = max(err, check_bf16(label, got, ref, roi[:N]) if bf16
                          else check_close(label, got, ref, BAR_K1_STD if std
                                           else BAR_K1_LIVE))
        for std in (False, True):
            big = kfn(roi, std)
            if not torch.equal(big, kfn(roi, std)):
                fail(f"{name} standardize={std}: two launches differ")
            for lo, hi in ((0, 1), (5, 6), (3, 17), (31, 33),
                           (2 * w - 2, 2 * w + 1)):
                if not torch.equal(kfn(roi[lo:hi].contiguous(), std),
                                   big[lo:hi]):
                    fail(f"{name} standardize={std}: frames {lo}:{hi} alone "
                         f"differ from the same frames in a batch of {2 * w + 1}")
        print(f"  {name}: two launches on {2 * w + 1} frames bitwise equal; "
              f"frames 0:1, 5:6, 3:17, 31:33 and {2 * w - 2}:{2 * w + 1} "
              "alone bitwise the same rows, standardize off and on")
        errs[name] = err
    return errs


def time_k1(p_cnn, flat, packs, roi, dev, card: str) -> dict:
    """K1 and K1-bf16 at N=8192 (the serving batch), 5,760 (the sweep's) and
    32 (B=1): the kernel (the host's launches held out,
    ``proto_parity_cnn.device_ms``), its plain version (TF32 off) and its
    bound (:func:`k1_bound`; a row over 100% of it fails); K1 at N=8192 also on
    the official init (the model's TinyROICNN, seed 0) beside the kernel
    row's weights. Returns {(name, N): row}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_cnn
    from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness
    from silent_speech_tpu_torch.scripts import proto_parity_e2e

    builds = {"roi_cnn": (flat, cuda_cnn.roi_cnn_fused,
                          cuda_cnn.roi_cnn_plain, False),
              "roi_cnn_bf16": (packs["roi_cnn_bf16"], cuda_cnn.roi_cnn_bf16,
                               cuda_cnn.roi_cnn_bf16_plain, True)}
    rows = {}
    for name, (fl, kfn, pfn, bf16) in builds.items():
        for N in (B_SERVE * T_SERVE, B_SWEEP * 90, T_SERVE):
            r = roi[:N]
            hold = harness.Args(N, dev, 20 if N > T_SERVE else 200)
            ms = harness.device_ms(
                lambda: kfn(r, p_cnn, impl="kernel", flat=fl), hold)
            with full_f32():
                plain = cuda_ms(lambda: pfn(r, p_cnn), 5)
            b_ms, b_by = k1_bound(N, CNN_FWD_MACS + 24 * 32,
                                  N * (48 * 96 + 4 * 32)
                                  + fl.element_size() * fl.numel(), bf16)
            share = check_bound(f"{name} N={N}", ms, b_ms)
            rows[name, N] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                             "bound_by": b_by, "share_of_bound": share,
                             "kernel_split": K1_SPLIT[bf16]}
            print(f"  {name} N={N}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), {share:.1%} of it; no "
                  f"single PyTorch call computes it {card}")
    N = B_SERVE * T_SERVE
    official = {k: {n: t.to(dev) for n, t in v.items()}
                for k, v in proto_parity_e2e.tiny_roi_cnn().items()}
    oflat = cuda_cnn.flat_weights(official)
    ms = harness.device_ms(lambda: cuda_cnn.roi_cnn_fused(
        roi[:N], official, impl="kernel", flat=oflat), harness.Args(N, dev, 20))
    rows["roi_cnn", N]["ms_official_init"] = ms
    print(f"  roi_cnn N={N} on the official init (the model's TinyROICNN, "
          f"seed 0): {ms:.4f} ms; on the kernel row's weights "
          f"{rows['roi_cnn', N]['ms']:.4f} ms {card}")
    return rows


def time_modes(p_cnn, packs, roi, k1: dict, dev, card: str) -> dict:
    """K4 and K5 at the sweep's N=5,760 and at N=8192 (the host's launches
    held out): the kernel, its plain version (TF32 off) and its bound (a
    row over 100% of it fails): K5 at K1's (:func:`k1_bound`, the FMAs and
    3xTF32 together over the function's multiply-adds), beside K1's time at
    the same N from :func:`time_k1`'s rows ``k1``; K4 at the int8 rate. At
    N=8192 also by stage: K5's debug stops and K4's check entry's stops.
    Returns {(name, N): row}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import (cuda_cnn, cuda_cnn_im2col,
                                             cuda_cnn_q8)

    q, w5 = packs["roi_cnn_q8"], packs["roi_cnn_im2col"]
    macs = CNN_FWD_MACS + 24 * 32
    io = lambda N: N * (48 * 96 + 4 * 32)
    rows = {}
    for N in (B_SWEEP * 90, roi.shape[0]):
        r = roi[:N]
        fns = {
            "roi_cnn_im2col": (
                lambda: cuda_cnn_im2col.roi_cnn_im2col(
                    r, p_cnn, impl="kernel", packed=w5),
                lambda: cuda_cnn.roi_cnn_plain(r, p_cnn),
                k1_bound(N, macs, io(N) + 4 * w5.numel())),
            "roi_cnn_q8": (
                lambda: cuda_cnn_q8.roi_cnn_q8(r, p_cnn, impl="kernel",
                                               packed=q),
                lambda: cuda_cnn_q8.roi_cnn_q8_plain(r, q),
                bound_ms(2 * N * macs, io(N) + 4 * (q["qi"].numel()
                                                   + q["qf"].numel()),
                         PEAK_INT8_OPS))}
        for kname, (kfn, pfn, (b_ms, b_by)) in fns.items():
            ms = held_ms(kfn, dev)
            with full_f32():
                p_ms = cuda_ms(pfn, 3, warmup=1)
            share = check_bound(f"{kname} N={N}", ms, b_ms)
            rows[kname, N] = {"ms": ms, "plain_ms": p_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "share_of_bound": share}
            print(f"  {kname} N={N}: kernel {ms:.4f} ms, plain {p_ms:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by}), {share:.1%} of it; no "
                  f"single PyTorch call computes it {card}")
        k5 = rows["roi_cnn_im2col", N]
        k5["ms_over_k1"] = k5["ms"] / k1["roi_cnn", N]["ms"]
        print(f"  roi_cnn_im2col / roi_cnn (K5 / K1) N={N}, the same frames "
              f"and weights: {k5['ms_over_k1']:.3f} {card}")
    N = roi.shape[0]
    # where the time goes: each frame ended at a stop (cumulative), then
    # the differences
    t5 = {s: held_ms(lambda: cuda_cnn_im2col.roi_cnn_im2col(
        roi, p_cnn, impl="kernel", packed=w5, debug_stop=s), dev)
        for s in cuda_cnn.DEBUG_STOPS}
    t4 = {s: held_ms(lambda: cuda_cnn_q8.roi_cnn_q8_entry(
        roi, p_cnn, q, stop=s), dev) for s in cuda_cnn_q8.STOPS}
    for kname, t in (("roi_cnn_im2col", t5), ("roi_cnn_q8", t4)):
        # each stop's time less the one before (the last stop's moments
        # cost more than the kernel's own means and fc: the whole kernel
        # is its own row)
        order = list(t)
        rows[kname, N]["stop_ms"] = dict(t)
        rows[kname, N]["stage_ms"] = {
            s: t[s] - (t[order[i - 1]] if i else 0.0)
            for i, s in enumerate(order)}
        print(f"  {kname} N={N} by stage (each frame ended at a stop, less "
              f"the stop before): " + ", ".join(
                  f"{s} {v:.4f}" for s, v in
                  rows[kname, N]["stage_ms"].items())
              + f" ms; the whole kernel {rows[kname, N]['ms']:.4f} ms {card}")
    return rows


# K3's timed batches: the serving batch's frames and the reference
# protocol's train step (B=16, T=90)
K3_STEP_N = B_TRAIN * T_TRAIN


def time_k3(p_cnn, flat, roi, dE, dev, card: str) -> dict:
    """K3 (standardize on, as training) at N=8192 and at the protocol
    step's 1,440 frames: the kernel (the host's launches held out), its
    plain version (autograd through cuDNN, TF32 off, forward included) and
    its bound: the recompute's and the gradients' multiply-adds (CNN_FWD_MACS
    + CNN_BWD_MACS + the fc's) at the f32 FMAs and 3xTF32 tensor cores
    together, as K1's f32 build (a row over 100% of it fails); at N=8192
    also by stage, each frame ended at the check entry's stops
    (cuda_cnn.BWD_STOPS). Returns {N: row}."""
    from silent_speech_tpu_torch.ops import cuda_cnn

    rows = {}
    for N in (roi.shape[0], K3_STEP_N):
        r, d = roi[:N], dE[:N]
        ms = held_ms(lambda: cuda_cnn.roi_cnn_weight_grads(
            r, d, flat, standardize=True), dev)
        plain = cuda_ms(lambda: plain_cnn_grads(r, d, p_cnn, True,
                                                torch.float32), 5)
        b_ms, b_by = k1_bound(N, CNN_FWD_MACS + CNN_BWD_MACS + 3 * 24 * 32,
                              N * (48 * 96 + 4 * 32) + 2 * 4 * flat.numel())
        share = check_bound(f"roi_cnn_bwd N={N}", ms, b_ms)
        rows[N] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                   "bound_by": b_by, "share_of_bound": share}
        print(f"  roi_cnn_bwd N={N} standardize=True: kernel {ms:.4f} ms, "
              f"plain (autograd through cuDNN, forward included) "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {share:.1%} of "
              f"it; no single PyTorch call computes it {card}")
    # where the time goes: each frame ended at a stop of the check entry
    t = {s: held_ms(lambda: cuda_cnn.roi_cnn_bwd_entry(
        roi, dE, flat, True, stop=s), dev)
        for s in cuda_cnn.BWD_STOPS}
    t["all"] = rows[roi.shape[0]]["ms"]
    order = list(t)
    stages = {s: t[s] - (t[order[i - 1]] if i else 0.0)
              for i, s in enumerate(order)}
    rows[roi.shape[0]]["stage_ms"] = stages
    print(f"  roi_cnn_bwd N={roi.shape[0]} by stage (each frame ended at a "
          f"stop): recompute {stages['forward']:.4f}, fc + dW3 + db3 "
          f"{stages['dw3']:.4f}, d p2 + db2 {stages['dp2']:.4f}, dW2 "
          f"{stages['dw2']:.4f}, d p1 + dW1 + db1 {stages['all']:.4f} ms "
          f"{card}")
    return rows


def write_train_corpus(out_dir: Path, words: list[str], per_word: int,
                       seed: int = SEED) -> None:
    """Synthetic clips of 20..90 frames through the port's data/synthetic.py,
    in the reference clip format."""
    from silent_speech_tpu_torch.core.schema import (Clip, clip_filename,
                                                     save_clip)
    from silent_speech_tpu_torch.data.synthetic import synthetic_clip

    rng = np.random.default_rng(seed)
    out_dir.mkdir(parents=True)
    for wi, word in enumerate(words):
        for j in range(per_word):
            T = int(rng.integers(20, 91))
            X, roi = synthetic_clip(rng, wi, T=T)
            save_clip(Clip(X=X, ts=np.arange(T) * 33, label=word,
                           speaker="smoke", roi=roi),
                      str(out_dir / clip_filename("smoke", word, 0,
                                                  wi * 100 + j)))


def train_batch(cfg, B: int, T: int, rng, dev):
    X = torch.from_numpy(rng.standard_normal((B, T, cfg.x_dim))
                         .astype(np.float32)).to(dev)
    L = torch.from_numpy(rng.integers(5, T + 1, B)).to(dev)
    L[0] = T
    R = torch.from_numpy(rng.integers(0, 256, (B, T, 48, 96),
                                      dtype=np.uint8)).to(dev)
    y = torch.from_numpy(rng.integers(0, cfg.num_classes, B)).to(dev)
    return X, L, R, y


def train_step_parity(params, cfg, batch, dev) -> None:
    """The official model's one-step parity (:func:`step_parity`): the
    training forward (standardized ROI), label-smoothed cross entropy,
    the global-norm clip at 1, Adam at lr 3e-4."""
    from silent_speech_tpu_torch.models.bigru import BiGRUClassifier
    from silent_speech_tpu_torch.train.step import smoothed_cross_entropy

    X, L, R, y = batch

    def loss_of(model, impl, train_cnn):
        logits = model.train_forward(
            X, L, R, generator=torch.Generator(device=dev), roi_impl=impl,
            train_cnn=train_cnn)
        return smoothed_cross_entropy(logits, y, cfg.num_classes, 0.05)

    step_parity(f"train step B={X.shape[0]} T={X.shape[1]}",
                lambda: BiGRUClassifier.from_jax_params(params, cfg),
                loss_of, 3e-4, 1.0, dev)


def step_parity(label: str, make_model, loss_of, lr: float,
                clip_norm: float, dev, loss_relative: bool = False) -> None:
    """One train step (forward, loss, backward, clip, Adam) from the same
    weights (``make_model()``, a CPU model) through the kernels and through
    the plain path, on the plain path's own route and along K1's (the
    branch the kernels' forward took: the plain ROI CNN is
    cuda_cnn_check.roi_cnn_plain_routed on the route K3's check entry
    reports): raises unless the loss, every gradient and every post-step
    parameter agree with both, K1's route differs from the plain forward's
    own only at near-ties (route_check), and every gradient is nonzero.
    ``loss_of(model, roi_impl, train_cnn)`` is the step's loss;
    ``loss_relative``: BAR_LOSS is taken relative to the loss where it is
    over 1 (a CTC loss is tens, and f32 holds it to about 1e-7 of itself).

    Adam's first step moves a parameter by lr g / (|g| + eps), about lr
    sign(g). On the plain path's own route a near-tie taken the other way
    moves a few gradient entries by about 1e-7, and where such an entry is
    near 0 its sign can change, so the parameter moves by up to 2 lr the
    other way. So, on its own route only, an entry whose gradient has
    opposite signs in the two runs while lying within BAR_K3 of its
    tensor's largest |g| in both (its sign is below the kernels' own
    accuracy) is held at 2 lr; every other entry, and every entry along
    K1's route, at BAR_PARAM."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import _kernels, cuda_cnn, cuda_cnn_check
    from silent_speech_tpu_torch.train.step import make_optimizer

    routes = []

    def along_k1(roi_u8, p, standardize):
        with torch.no_grad():
            emb = p["fc"]["b"].shape[0]
            _, _, route = cuda_cnn_check.roi_cnn_bwd_check(
                roi_u8.contiguous(), torch.zeros(roi_u8.shape[0], emb,
                                                 device=roi_u8.device),
                cuda_cnn.flat_weights(p), standardize=standardize)
        routes.append((roi_u8, {k: {n: t.detach().clone()  # before Adam
                                    for n, t in v.items()}
                                for k, v in p.items()}, standardize, route))
        return cuda_cnn_check.roi_cnn_plain_routed(roi_u8, p, standardize,
                                                   route)

    res = {}
    for run in ("kernel", "plain", "routed"):
        impl = "kernel" if run == "kernel" else "plain"
        model = make_model().to(dev)
        opt = make_optimizer(model, lr, clip_norm)
        before = _kernels.launch_counts()
        with full_f32():
            loss = loss_of(model, impl,
                           along_k1 if run == "routed" else None)
            opt.zero_grad()
            loss.backward()
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            opt.step()
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        want = 1 if impl == "kernel" else 0
        if launched["roi_cnn"] != want or launched["roi_cnn_bwd"] != want:
            fail(f"{label} roi_impl={impl}: launches {launched}")
        zero = [n for n, g in grads.items() if not g.abs().max() > 0]
        if zero:
            fail(f"{label} roi_impl={impl}: zero gradient for {zero}")
        res[run] = (loss.item(), grads,
                    {n: p.detach().clone()
                     for n, p in model.named_parameters()})
    roi, p_roi, std, route = routes[0]
    gaps = route_check(label, roi, p_roi, std, route)
    lk, gk, pk = res["kernel"]
    below = lambda g: g.abs() <= BAR_K3 * g.abs().max()
    for run in ("routed", "plain"):
        lp, gp, pp = res[run]
        flip = {n: (gk[n] * gp[n] < 0) & below(gk[n]) & below(gp[n])
                if run == "plain" else torch.zeros_like(gk[n], dtype=bool)
                for n in gk}
        dp = {n: (pk[n] - pp[n]).abs() for n in pk}
        diff = {"loss": abs(lk - lp),
                "grad": max((gk[n] - gp[n]).abs().max().item() for n in gk),
                "param": max((dp[n][~flip[n]].max().item() for n in pk
                              if not flip[n].all()), default=0.0)}
        n_flip = sum(int(f.sum()) for f in flip.values())
        d_flip = max((dp[n][flip[n]].max().item() for n in pk
                      if flip[n].any()), default=0.0)
        route_name = "along K1's" if run == "routed" else "on its own"
        bar_loss = BAR_LOSS * (max(1.0, abs(lp)) if loss_relative else 1.0)
        print(f"  {label} kernels vs plain {route_name} route: "
              f"loss {lk:.6f} vs {lp:.6f} (|d| {diff['loss']:.2e}, bar "
              f"{bar_loss:g}), grads max |d| {diff['grad']:.2e} (bar "
              f"{BAR_GRAD:g}), params after Adam max |d| {diff['param']:.2e} "
              f"(bar {BAR_PARAM:g})"
              + (f"; {n_flip} entries whose gradient changes sign within "
                 f"BAR_K3 of its tensor's largest: max |d| {d_flip:.2e} "
                 f"(bar 2 lr = {2 * lr:g})" if run == "plain" else ""))
        for key, bar in (("loss", bar_loss), ("grad", BAR_GRAD),
                         ("param", BAR_PARAM)):
            if not diff[key] <= bar:
                fail(f"{label} ({run}) {key} differs by {diff[key]:.2e} "
                     f"> {bar:g}")
        if not d_flip <= 2 * lr:
            fail(f"{label} ({run}): a parameter whose gradient changes "
                 f"sign differs by {d_flip:.2e} > {2 * lr:g}")
    print(f"    {gaps}; every gradient nonzero")


def train_step_fn(params, cfg, batch, dev, impl):
    """A closure running one full train step (dropout and augmentation as
    the official recipe) on ``batch``."""
    from silent_speech_tpu_torch.data.augment import OFFICIAL_AUGMENT
    from silent_speech_tpu_torch.models.bigru import BiGRUClassifier
    from silent_speech_tpu_torch.train.step import (StepConfig,
                                                    make_optimizer,
                                                    train_step)

    model = BiGRUClassifier.from_jax_params(params, cfg).to(dev)
    opt = make_optimizer(model, 3e-4)
    scfg = StepConfig(model=cfg, augment=OFFICIAL_AUGMENT, roi_impl=impl)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return lambda: train_step(model, opt, scfg, *batch, gen)


def nn_gru(p, D: int, bidirectional: bool,
           dev: torch.device) -> torch.nn.GRU:
    """torch.nn.GRU (cuDNN) with the weights ``p``: one layer whose
    directions each take the dict ``p``, or a list of layers, each
    {"fwd": ..., "bwd": ...} (the model's ``kernel_weights()["gru"]``)."""
    layers = p if isinstance(p, list) else [{"fwd": p, "bwd": p}]
    H = layers[0]["fwd"]["wh"].shape[0]
    gru = torch.nn.GRU(D, H, num_layers=len(layers), batch_first=True,
                       bidirectional=bidirectional).to(dev)
    with torch.no_grad():
        for i, lp in enumerate(layers):
            for sfx, d in ((f"l{i}", "fwd"),
                           (f"l{i}_reverse", "bwd"))[:1 + bidirectional]:
                getattr(gru, f"weight_ih_{sfx}").copy_(lp[d]["wi"].t())
                getattr(gru, f"weight_hh_{sfx}").copy_(lp[d]["wh"].t())
                getattr(gru, f"bias_ih_{sfx}").copy_(lp[d]["bi"])
                getattr(gru, f"bias_hh_{sfx}").copy_(lp[d]["bh"])
    return gru


def held_ms(fn, dev, iters: int = 20) -> float:
    """Mean device ms a call, the host's launches held out
    (``proto_parity_cnn.device_ms``: a spin kernel holds the stream while
    the host enqueues the calls)."""
    from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness

    return harness.device_ms(fn, harness.Args(0, dev, iters))


def gru_library_ms(p, x: torch.Tensor, lengths: torch.Tensor,
                   bidirectional: bool = True) -> tuple[float, float]:
    """torch.nn.GRU (cuDNN), one bidirectional (or forward) layer with each
    direction's weights ``p`` (or the layers of :func:`nn_gru`'s list), on
    a sequence packed once before the calls:
    (the held-stream timer's ms, CUDA events as the host launches). Each is
    an upper bound of its device time (the first if the call waits on the
    host, the second if the host launches slower than the card runs). The
    caller sets TF32: with it cuDNN computes another function."""
    from torch.nn.utils.rnn import pack_padded_sequence

    gru = nn_gru(p, x.shape[-1], bidirectional, x.device)
    seq = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                               enforce_sorted=False)

    def run():
        with torch.no_grad():
            gru(seq)
    return held_ms(run, x.device), cuda_ms(run, 20)


def check_k2_parts(gru_p: dict, lengths: torch.Tensor, dev
                   ) -> tuple[float, float]:
    """Each of K2's two kernels against its own plain version (TF32 off)
    on the layers' shapes (D=212 and 384, H=192, both directions in one
    launch as the model runs them) at B=1, 64, B_SERVE and 1024 (the split
    tile and three tiled ones), T_SERVE: gru_proj on each of its routes
    (small M and large M; the one the kernel takes at the shape printed
    with its plan) against the matmul and twice on the same inputs
    (bitwise equal), gru_seq over gru_proj's output against the masked
    recurrence, and gru_seq twice on the same inputs (bitwise equal).
    Prints the plans (gru_seq: C, BT, the route of Wh). Returns the two
    largest errors."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_gru
    from silent_speech_tpu_torch.ops.nn import gru_dir_init

    gen = torch.Generator().manual_seed(SEED + 7)
    proj_err = seq_err = 0.0
    for D, pf in gru_p.items():
        pb = {k: v.to(dev) for k, v in gru_dir_init(D, 192, gen).items()}
        pack = cuda_gru.pack_layer([(pf, False), (pb, True)])
        N = pack.wi.shape[1]
        for B in (1, 64, B_SERVE, 1024):
            x = torch.randn(B, T_SERVE, D, generator=gen).to(dev)
            L = torch.randint(1, T_SERVE + 1, (B,), generator=gen)
            L[0] = T_SERVE
            L = L.to(dev)
            pl = cuda_gru.plan(B, 192, 2)
            label = (f"B={B} D={D} (C={pl.C} BT={pl.BT} Wh in "
                     f"{'shared' if pl.smem_w else 'device'} memory)")
            xp = cuda_gru.gru_proj(x, pack.wi, pack.bi, impl="kernel",
                                   wt=pack.wt)
            y = cuda_gru.gru_recurrence(xp, L, pack, impl="kernel")
            again = cuda_gru.gru_recurrence(xp, L, pack, impl="kernel")
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                fail(f"gru_seq {label}: two calls on the same inputs differ")
            with full_f32():
                ref_xp = cuda_gru.gru_proj_plain(x, pack.wi, pack.bi)
                ref_y = cuda_gru.gru_recurrence(xp, L, pack, impl="plain")
            taken = cuda_gru.proj_plan(B * T_SERVE, D, N)
            for route in cuda_gru.PROJ_ROUTES:
                got = cuda_gru.gru_proj(x, pack.wi, pack.bi, impl="kernel",
                                        route=route, wt=pack.wt)
                rep = cuda_gru.gru_proj(x, pack.wi, pack.bi, impl="kernel",
                                        route=route, wt=pack.wt)
                torch.cuda.synchronize()
                rp = cuda_gru.proj_plan(B * T_SERVE, D, N, route)
                chosen = ", the shapes' choice" if route == taken.route \
                    else ""
                name = (f"gru_proj B={B} D={D} route {route} ({rp.bm} x "
                        f"{rp.bn} tiles, {rp.blocks} blocks{chosen})")
                if not torch.equal(got, rep):
                    fail(f"{name}: two calls on the same inputs differ")
                if route == taken.route and not torch.equal(got, xp):
                    fail(f"{name}: the forced route differs from the chosen")
                proj_err = max(proj_err, check_close(name, got, ref_xp,
                                                     BAR_GRU))
            seq_err = max(seq_err, check_close(
                f"gru_seq (recurrence) {label}", y, ref_y, BAR_GRU))
    return proj_err, seq_err


def time_k2(p: dict, x: torch.Tensor, lengths: torch.Tensor, dev,
            card: str) -> dict:
    """K2 on one bidirectional layer (D=212, H=192, T_SERVE, both
    directions' weights ``p``) at each B of K2_B: the layer (gru_proj then
    gru_seq, through bigru_kernel), each kernel alone, and torch.nn.GRU on
    the same inputs, all with the host's launches held out (held_ms; the
    library also with CUDA events as the host launches, the smaller
    taken); the plain versions with CUDA events (TF32 off); the bounds
    over this run's lengths (the layer's and gru_proj's at the f32 FMAs and
    3xTF32 together, :func:`tc_bound`: gru_proj's large route runs
    3xTF32; gru_seq's at the f32 rate). ``x`` and ``lengths`` are
    B_SERVE's inputs; the other B draw theirs from SEED + 8. Fails if a
    time is under its bound. Returns {B: {key: value}}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_gru
    from silent_speech_tpu_torch.ops import gru as gru_ops

    gen = torch.Generator().manual_seed(SEED + 8)
    D, H, T = x.shape[-1], p["wh"].shape[0], T_SERVE
    pack = cuda_gru.pack_layer([(p, False), (p, True)])
    layer = [{"fwd": p, "bwd": p, "packed": pack}]
    out = {}
    for B in K2_B:
        if B == B_SERVE:
            xb, L = x, lengths
        else:
            xb = torch.randn(B, T, D, generator=gen).to(dev)
            L = torch.randint(5, T + 1, (B,), generator=gen)
            L[0] = T
        Ld = L.to(dev)
        S = int(L.sum())
        pl = cuda_gru.plan(B, H, 2)
        xp = cuda_gru.gru_proj(xb, pack.wi, pack.bi, impl="kernel",
                               wt=pack.wt)
        r = {"C": pl.C, "BT": pl.BT, "wh_in": "shared memory" if pl.smem_w
             else "device memory", "blocks": pl.blocks,
             "threads": pl.threads, "smem_bytes": pl.smem,
             "card_clusters": pl.clusters, "waves": pl.waves}
        r["layer_ms"] = held_ms(lambda: cuda_gru.bigru_kernel(
            xb, Ld, layer, impl="kernel"), dev)
        r["proj_ms"] = held_ms(lambda: cuda_gru.gru_proj(
            xb, pack.wi, pack.bi, impl="kernel", wt=pack.wt), dev)
        r["seq_ms"] = held_ms(lambda: cuda_gru.gru_recurrence(
            xp, Ld, pack, impl="kernel"), dev)
        with full_f32():  # TF32 is another function (PERF.md, PR 8)
            held, events = gru_library_ms(p, xb, L)
        r["layer_library_held_ms"] = held
        r["layer_library_events_ms"] = events
        r["layer_library_ms"] = min(held, events)
        r["layer_library_tf32_ms"] = min(gru_library_ms(p, xb, L))
        x2 = xb.reshape(-1, D)
        with full_f32():
            r["layer_plain_ms"] = cuda_ms(lambda: gru_ops.bigru(
                xb, Ld, layer), 5, warmup=1)
            r["proj_plain_ms"] = cuda_ms(lambda: cuda_gru.gru_proj_plain(
                xb, pack.wi, pack.bi), 20)
            r["proj_library_ms"] = held_ms(lambda: torch.addmm(
                pack.bi, x2, pack.wi), dev)
            r["seq_plain_ms"] = cuda_ms(lambda: cuda_gru.gru_recurrence(
                xp, Ld, pack, impl="plain"), 5, warmup=1)
        r["layer_bound_ms"], r["layer_bound_by"] = tc_bound(
            2 * 2 * S * (D + H) * 3 * H,
            4 * (xb.numel() + 2 * ((D + H) * 3 * H + 6 * H) + B * T * 2 * H))
        r["proj_bound_ms"], r["proj_bound_by"] = proj_bound(B * T, D, 6 * H)
        r["seq_bound_ms"], r["seq_bound_by"] = bound_ms(
            2 * 2 * S * H * 3 * H,
            4 * (B * T * 6 * H + 2 * (H * 3 * H + 3 * H) + B * T * 2 * H + B))
        print(f"  K2 one bidirectional layer B={B} T={T} D={D} H={H} (C="
              f"{pl.C} blocks a cluster, BT={pl.BT} rows a cluster, Wh in "
              f"{r['wh_in']}, {pl.blocks} blocks of {pl.threads} threads, "
              f"{pl.smem} B of shared memory; the card runs "
              f"{pl.clusters} such clusters at once, so {pl.waves} wave(s)):"
              f" layer {r['layer_ms']:.4f} ms "
              f"(gru_proj {r['proj_ms']:.4f} + gru_seq {r['seq_ms']:.4f}), "
              f"torch.nn.GRU (cuDNN, packed once, TF32 off) "
              f"{r['layer_library_ms']:.4f} ms (held {held:.4f}, events "
              f"{events:.4f}; with TF32 {r['layer_library_tf32_ms']:.4f}): "
              f"{'' if r['layer_ms'] < r['layer_library_ms'] else 'NOT '}"
              f"faster x{r['layer_library_ms'] / r['layer_ms']:.2f}; plain "
              f"{r['layer_plain_ms']:.4f} ms; bound "
              f"{r['layer_bound_ms']:.4f} ms ({r['layer_bound_by']}) {card}")
        print(f"    gru_proj: {r['proj_ms']:.4f} ms, plain (matmul) "
              f"{r['proj_plain_ms']:.4f}, torch.addmm "
              f"{r['proj_library_ms']:.4f}, bound {r['proj_bound_ms']:.4f} "
              f"({r['proj_bound_by']}); gru_seq: {r['seq_ms']:.4f} ms, plain "
              f"{r['seq_plain_ms']:.4f}, bound {r['seq_bound_ms']:.4f} "
              f"({r['seq_bound_by']}) {card}")
        for key in ("layer_", "proj_", "seq_"):
            if r[key + "ms"] < r[key + "bound_ms"]:
                fail(f"K2 {key[:-1]} B={B}: {r[key + 'ms']:.4f} ms is "
                     f"under its bound {r[key + 'bound_ms']:.4f} ms")
        out[B] = r
    return out


def k2_run(path: str) -> None:
    """K2 (bigru_kernel: gru_proj then gru_seq, both directions) over the
    serving stack's shapes (H=192, D=212 then 384, T_SERVE) at each B of
    K2_B, weights and inputs drawn from SEED + 9; saves the outputs and each
    stack's held-stream ms to ``path`` (torch.save). It runs the package
    first on sys.path: :func:`k2_against_parent` runs it in a parent's
    checkout too."""
    from silent_speech_tpu_torch.ops import cuda_gru
    from silent_speech_tpu_torch.ops.nn import gru_dir_init

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 9)
    layers = [{d: {k: v.to(dev) for k, v in gru_dir_init(D, 192, gen).items()}
               for d in ("fwd", "bwd")} for D in (212, 384)]
    res = {"out": {}, "ms": {}}
    with torch.no_grad():
        for B in K2_B:
            x = torch.randn(B, T_SERVE, 212, generator=gen).to(dev)
            L = torch.randint(1, T_SERVE + 1, (B,), generator=gen)
            L[0] = T_SERVE
            L = L.to(dev)
            run = lambda: cuda_gru.bigru_kernel(x, L, layers, impl="kernel")
            res["out"][B] = run().cpu()
            res["ms"][B] = held_ms(run, dev)
    torch.save(res, path)


def k2_against_parent(parent: Path, card: str) -> dict:
    """K2 in this tree and in the parent's checkout at ``parent``, each in
    its own process, in turns (parent, this, this, parent):
    :func:`k2_run`'s outputs must be bitwise equal in all four; returns
    {B: (parent ms, this ms)}, each the mean of its two turns."""
    code = ("import importlib.util as u; s = u.spec_from_file_location("
            "'smoke', {!r}); m = u.module_from_spec(s); "
            "s.loader.exec_module(m); m.k2_run({!r})")
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, tree in enumerate((parent, ROOT, ROOT, parent)):
        path = work / f"k2_turn{i}.pt"
        subprocess.run([sys.executable, "-c", code.format(
            str(ROOT / "chip_smoke.py"), str(path))], cwd=tree, check=True)
        runs.append(torch.load(path))
    for i, r in enumerate(runs[1:], 1):
        for B, y in r["out"].items():
            if not torch.equal(y, runs[0]["out"][B]):
                fail(f"K2 B={B}: turn {i} differs from the parent's by "
                     f"{(y - runs[0]['out'][B]).abs().max().item():.3e}")
    out = {}
    for B in K2_B:
        par = (runs[0]["ms"][B] + runs[3]["ms"][B]) / 2
        this = (runs[1]["ms"][B] + runs[2]["ms"][B]) / 2
        out[B] = (par, this)
        print(f"  K2 stack B={B}: bitwise the parent's; parent "
              f"{runs[0]['ms'][B]:.4f} / {runs[3]['ms'][B]:.4f} ms, this "
              f"{runs[1]['ms'][B]:.4f} / {runs[2]['ms'][B]:.4f} ms "
              f"(this / parent {this / par:.4f}) {card}")
    return out


# gru_proj's shapes on the paths, rows M = B T at N = 1152: K2_B's at
# T_SERVE (live and serving), the checks' B=64, the CTC step's B=64 x
# T=80, the sweep's B=64 x max_t 90, and M=1,024
K2P_M = (("B=1", 1 * T_SERVE), ("M=1024", 1024), ("B=64", 64 * T_SERVE),
         ("ctc M=5120", 5120), ("sweep M=5760", 5760),
         ("B=256", 256 * T_SERVE), ("B=1024", 1024 * T_SERVE))


def time_k2p(gru_p: dict, dev, card: str) -> dict:
    """gru_proj (K2p) alone on a layer's shapes, both directions (N = 6H =
    1152), D=212 and 384 (the serving model's two layers), at each M of
    K2P_M: the kernel on the route it takes and on each route; the large
    route at each tile width of PROJ_BNS and with one TF32 pass at the
    chosen width (another function: what the two extra passes cost), both
    through the timing stop gru_proj_stop, whose 3-pass output at the
    chosen width must be bitwise gru_proj's; all with the host's launches
    held out (held_ms); the plain version with CUDA events (TF32 off),
    torch.addmm (the library call, held_ms); the bound (:func:`proj_bound`);
    the plan; the large route's output against the float64 product, its
    share of tf32_bars.bar64 (nt's bar, one step: measured, not held; the
    route takes a tile's chunks in one wgmma sum, where nt adds the chunks'
    sums in f32). Fails if the kernel runs under its bound. Returns {"D=..":
    {label: {key: value}}}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_gru, tf32_bars

    gen = torch.Generator().manual_seed(SEED + 9)
    out = {}
    for D, p in gru_p.items():
        pack = cuda_gru.pack_layer([(p, False), (p, True)])
        N = pack.wi.shape[1]
        rows = {}
        for label, M in K2P_M:
            x = torch.randn(M, D, generator=gen).to(dev)
            pl = cuda_gru.proj_plan(M, D, N)

            def call(route=None):
                return lambda: cuda_gru.gru_proj(
                    x, pack.wi, pack.bi, impl="kernel", route=route,
                    wt=pack.wt)

            def stop(bn=0, passes=3):
                return lambda: cuda_gru.gru_proj_stop(
                    x, pack.wt, pack.bi, bn=bn, passes=passes)
            large = cuda_gru.gru_proj(x, pack.wi, pack.bi, impl="kernel",
                                      route="large", wt=pack.wt)
            if not torch.equal(stop()(), large):
                fail(f"gru_proj_stop M={M} D={D}: not bitwise the large "
                     "route's output")
            x64, wi64, bi64 = x.double(), pack.wi.double(), pack.bi.double()
            ref = x64 @ wi64 + bi64
            r = {"M": M, "route": pl.route, "tile": f"{pl.bm}x{pl.bn}",
                 "tiles": pl.tiles, "blocks": pl.blocks, "smem_bytes":
                 pl.smem, "stages": pl.stages, "ms": held_ms(call(), dev),
                 **{"large_" + k: v for k, v in tf32_bars.shares(
                     large.double(), ref, tf32_bars.bar64(
                         ref, x64.abs() @ wi64.abs() + bi64.abs()),
                     "64").items()}}
            del x64, ref
            for route in cuda_gru.PROJ_ROUTES:
                r[route + "_ms"] = held_ms(call(route), dev)
            for bn in cuda_gru.PROJ_BNS:
                r[f"large_bn{bn}_ms"] = held_ms(stop(bn), dev)
            r["large_one_pass_ms"] = held_ms(stop(passes=1), dev)
            with full_f32():
                r["plain_ms"] = cuda_ms(lambda: cuda_gru.gru_proj_plain(
                    x, pack.wi, pack.bi), 20)
                r["library_ms"] = held_ms(lambda: torch.addmm(
                    pack.bi, x, pack.wi), dev)
            r["bound_ms"], r["bound_by"] = proj_bound(M, D, N)
            r["share_of_bound"] = check_bound(
                f"gru_proj M={M} D={D}", r["ms"], r["bound_ms"])
            widths = ", ".join(f"BN {bn} {r[f'large_bn{bn}_ms']:.4f}"
                               for bn in cuda_gru.PROJ_BNS)
            print(f"  gru_proj {label} (M={M}) D={D} N={N} (route "
                  f"{pl.route}, {pl.bm} x {pl.bn} tiles, {pl.tiles} tiles on "
                  f"{pl.blocks} blocks, {pl.smem} B of shared memory, "
                  f"{pl.stages} stage(s)): {r['ms']:.4f} ms "
                  f"({r['share_of_bound']:.1%} of its bound "
                  f"{r['bound_ms']:.4f} ms, {r['bound_by']}); routes small "
                  f"{r['small_ms']:.4f}, large {r['large_ms']:.4f} ({widths}"
                  f"), large with one TF32 pass {r['large_one_pass_ms']:.4f}"
                  f"; the large route {r['large_share_of_bar64']:.3f} of the "
                  f"float64 bar (max difference "
                  f"{r['large_max_abs_err64']:.3e}); plain "
                  f"{r['plain_ms']:.4f}; torch.addmm "
                  f"{r['library_ms']:.4f}: "
                  f"{'' if r['ms'] < r['library_ms'] else 'NOT '}faster "
                  f"x{r['library_ms'] / r['ms']:.2f} {card}")
            rows[label] = r
        out[f"D={D}"] = rows
    return out


def time_dc_variants(dev, card: str) -> dict:
    """The bf16 chain (DC-bf16) at probe_int8's size (256 steps, K=384
    and 512) in each of its variants, clusters of 1, 2, 3 and 6 blocks,
    with the host's launches held out
    (proto_parity_cnn.device_ms, RATE_ITERS calls), each variant's output
    bitwise the check instantiation's of the kernel's own choice
    (:func:`ops.cuda_dot_chain.plan`), beside the bf16 bound (over 100%
    fails). Returns {"K=..": {"chosen": plan, "c<C>": {...}}}."""
    from silent_speech_tpu_torch.ops import cuda_dot_chain as dc
    from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness

    rng = np.random.default_rng(SEED + 12)
    x = torch.from_numpy(rng.integers(0, 256, (dc.GRID * 8, 128),
                                      dtype=np.uint8)).to(dev)
    args = harness.Args(0, dev, RATE_ITERS)
    out = {}
    for K in dc.KS:
        w = dc.make_weights("bf16", K).to(dev)
        packed = dc.pack_weights(w, "bf16")
        want, _, _ = dc.dot_chain(x, w, "bf16", packed=packed, check=True)
        b_ms, b_by = harness.bound_ms(dc.macs(dc.GRID, K),
                                      dc.bytes_moved(dc.GRID, K, "bf16"),
                                      "bf16")
        chosen = dc.plan(K)
        rows = {"chosen": chosen._asdict(), "bound_ms": b_ms,
                "bound_by": b_by}
        print(f"  dot_chain bf16 K={K}: the kernel's choice clusters of "
              f"{chosen.cluster}, {chosen.stages} stages of "
              f"{chosen.chunk} B, {chosen.smem} B of shared memory a block, "
              f"{chosen.clusters} clusters at once on {chosen.sms_used} of "
              f"{chosen.sms} SMs; bound {b_ms:.4f} ms ({b_by}) {card}")
        for c in dc.BF16_CLUSTERS:
            got = dc.dot_chain(x, w, "bf16", packed=packed, cluster=c)
            if not torch.equal(got, want):
                fail(f"dot_chain bf16 K={K} cluster {c}: not bitwise the "
                     "check instantiation's output")
            pl = dc.plan(K, c)
            ms = harness.device_ms(lambda: dc.dot_chain(
                x, w, "bf16", packed=packed, cluster=c), args)
            share = check_bound(f"dot_chain bf16 K={K} c{c}", ms, b_ms)
            rows[f"c{c}"] = {"ms": ms, "share_of_bound": share,
                             "clusters": pl.clusters,
                             "sms_used": pl.sms_used}
            print(f"    clusters of {c} ({pl.clusters} at once on "
                  f"{pl.sms_used} SMs): {ms:.4f} ms, {share:.1%} of the "
                  f"bound {card}")
        out[f"K={K}"] = rows
    return out


def time_mr_dc_f32(dev, card: str) -> dict:
    """MR at its six shapes (64 reps x 64 steps) and DC-f32 (256 steps, K
    384 and 512) with the host's launches held out (proto_parity_cnn.
    device_ms): MR whole, in one TF32 pass (hi*hi alone) and its feed alone
    (copies, fragment loads, splits and adds, no wgmmas), the stops of
    cuda_mm_rate.mm_rate_stop, and at each column tile (BN 64 and 128,
    each bitwise the plan's), beside the bound at 232 TFLOP/s; DC-f32
    whole, in one TF32 pass, without the exchange of y between products
    and without W's feed after the ring's first fill
    (cuda_dot_chain.dot_chain_f32_stop). Returns {"mm_rate": {shape:
    {...}}, "dot_chain_f32": {"K=..": {...}}}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_dot_chain as dc
    from silent_speech_tpu_torch.ops import cuda_mm_rate as mr
    from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness

    args = harness.Args(0, dev, 2)
    out = {"mm_rate": {}, "dot_chain_f32": {}}
    with torch.no_grad(), full_f32():
        for M, K, N, _ in mr.SHAPES:
            a, b = mr.make_problem(M, K, N, dev)
            b_ms, _ = harness.bound_ms(mr.macs(M, K, N), 0, "f32_3xtf32")
            row = {"ms": harness.device_ms(lambda: mr.mm_rate(a, b), args),
                   "bound_ms": b_ms}
            want = mr.mm_rate(a, b)
            for bn in mr.BNS:  # each tile: the same bits, its time
                if not torch.equal(mr.mm_rate(a, b, bn=bn), want):
                    fail(f"mm_rate ({M},{K},{N}) BN {bn}: not bitwise the "
                         "plan's tile")
                row[f"bn{bn}_ms"] = harness.device_ms(
                    lambda: mr.mm_rate(a, b, bn=bn), args)
            for stop in ("one_pass", "feed"):
                row[f"{stop}_ms"] = harness.device_ms(
                    lambda: mr.mm_rate_stop(a, b, stop=stop), args)
            row["share_of_bound"] = check_bound(f"mm_rate ({M},{K},{N})",
                                                row["ms"], b_ms)
            print(f"  mm_rate ({M},{K},{N}) BN {mr.plan(M, K, N).bn}: "
                  f"{row['ms']:.4f} ms ({row['share_of_bound']:.1%} of "
                  f"{b_ms:.4f}); BN 128 {row['bn128_ms']:.4f}, BN 64 "
                  f"{row['bn64_ms']:.4f}; one TF32 pass "
                  f"{row['one_pass_ms']:.4f}; the feed alone "
                  f"{row['feed_ms']:.4f} {card}")
            out["mm_rate"][f"{M}x{K}x{N}"] = row
        rng = np.random.default_rng(SEED + 13)
        x = torch.from_numpy(rng.integers(0, 256, (dc.GRID * 8, 128),
                                          dtype=np.uint8)).to(dev)
        for K in dc.KS:
            w = dc.make_weights("f32", K).to(dev)
            packed = dc.pack_weights(w, "f32")
            b_ms, _ = harness.bound_ms(dc.macs(dc.GRID, K), 0, "f32_3xtf32")
            few = args._replace(iters=RATE_ITERS)
            ms = harness.device_ms(lambda: dc.dot_chain(
                x, w, "f32", packed=packed), few)
            row = {"ms": ms, "bound_ms": b_ms,
                   "share_of_bound": check_bound(f"dot_chain f32 K={K}", ms,
                                                 b_ms)}
            for stop in dc.F32_STOPS:
                row[f"{stop}_ms"] = harness.device_ms(
                    lambda: dc.dot_chain_f32_stop(x, w, stop, packed=packed),
                    few)
            print(f"  dot_chain f32 K={K}: {ms:.4f} ms "
                  f"({row['share_of_bound']:.1%} of {b_ms:.4f}); one TF32 "
                  f"pass {row['one_pass_ms']:.4f}; no exchange "
                  f"{row['no_exchange_ms']:.4f}; no feed "
                  f"{row['no_feed_ms']:.4f} {card}")
            out["dot_chain_f32"][f"K={K}"] = row
    return out


def plan_str(pl) -> str:
    """A probe kernel's plan (ops/cuda_gru_proto.ProbePlan) in a few words."""
    return (f"C={pl.C} BT={pl.BT} {pl.threads} thr {pl.smem} B, "
            f"{pl.blocks} blocks, {pl.clusters} clusters at once, "
            f"{pl.waves} wave(s)")


def check_gru_probes(gen, dev) -> dict:
    """The GRU probes' kernels against their plain versions (TF32 off): the
    recurrence kernel with one weight set (P2a) and two (P2b), K2's
    one-direction launch as proto_gru3's route (P3, f32: K2 has no bf16
    build) and the dual-chain kernel (P4), at B in PROBE_B, T=32, lengths
    that include T and 1, D in PROBE_D, with and without bf16_mm, each at
    its plan's tile (printed). Returns each kernel's largest error; raises
    on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_gru_proto as gp
    from silent_speech_tpu_torch.ops import gru as gru_ops
    from silent_speech_tpu_torch.ops.nn import gru_dir_init
    from silent_speech_tpu_torch.scripts import proto_gru3

    T, H = PROBE_T, PROBE_H
    errs = dict.fromkeys(PROBE_KERNELS, 0.0)

    def check(name, label, got, ref, bar):
        errs[name] = max(errs[name], check_close(f"{name} {label}", got, ref,
                                                 bar))

    for D in PROBE_D:
        pf, pb = [{k: v.to(dev) for k, v in gru_dir_init(D, H, gen).items()}
                  for _ in range(2)]
        wh2, bh2 = (torch.stack([pf[k], pb[k]]) for k in ("wh", "bh"))
        for B in PROBE_B:
            x = torch.randn(B, T, D, generator=gen).to(dev)
            L = torch.randint(1, T + 1, (B,), generator=gen)
            L[0] = T
            if B > 1:
                L[-1] = 1
            L = L.to(dev)
            for bf16 in (False, True):
                print(f"  plans B={B} D={D} bf16_mm={bf16}: "
                      + "; ".join(f"{n} {plan_str(pl)}" for n, pl in (
                          ("gru_kstep", gp.rec_plan(B, 1, H, bf16_mm=bf16)),
                          ("gru_kstep_2w", gp.rec_plan(B, 2, H,
                                                       bf16_mm=bf16)),
                          ("gru_dual", gp.dual_plan(B, D, H, T,
                                                    bf16_mm=bf16)))))
            with full_f32():
                x_flip = gru_ops.flip_padded(x, L)
                xp_f = x @ pf["wi"] + pf["bi"]
                xp_b = x_flip @ pb["wi"] + pb["bi"]
                got = proto_gru3.gru_sequence_fusedproj(
                    x, L, pf["wi"], pf["bi"], pf["wh"], pf["bh"],
                    impl="kernel")
                ref = gru_ops.gru_layer_single_direction(x, L, pf)[0]
                check("gru_fusedproj", f"B={B} D={D}", got, ref, BAR_GRU)
                for bf16 in (False, True):
                    label = f"B={B} D={D} bf16_mm={bf16}"
                    bar = BAR_GRU_BF16 if bf16 else BAR_GRU
                    ref_f = gp.gru_recurrence_plain(xp_f, L, pf["wh"],
                                                    pf["bh"], bf16)
                    ref_b = gp.gru_recurrence_plain(xp_b, L, pb["wh"],
                                                    pb["bh"], bf16)
                    got = gp.gru_sequence_kstep(xp_f, L, pf["wh"], pf["bh"],
                                                bf16_mm=bf16, impl="kernel")
                    check("gru_kstep", label, got, ref_f, bar)
                    got = gp.gru_sequence_kstep_2w(
                        torch.cat([xp_f, xp_b]), L.repeat(2), wh2, bh2,
                        bf16_mm=bf16, impl="kernel")
                    check("gru_kstep_2w", label, got,
                          torch.cat([ref_f, ref_b]), bar)
                    got = gp.gru_layer_dual(x, x_flip, L, pf, pb,
                                            bf16_mm=bf16, impl="kernel")
                    ref = gp.gru_layer_dual_plain(x, x_flip, L, pf, pb, bf16)
                    for half, g, r in zip(("y_f", "y_b"), got, ref):
                        check("gru_dual", f"{label} {half}", g, r, bar)
    return errs


def split_bound(rec_ops: float, rec_peak: float, proj_ops: float,
                proj_peak: float, nbytes: float) -> tuple[float, str]:
    """A GRU probe's least time with each part at the card's rate for its
    type: the recurrence's multiply-adds at ``rec_peak`` (67 TFLOP/s, the
    f32 FMAs, in f32; 989 under bf16_mm, whose products are of bf16 values
    summed in f32, what bf16 MMA computes), the projection's at
    ``proj_peak`` (232 for 3xTF32 with the FMAs, 989 for the bf16_mm pass,
    67 for K2p's small route), or the bytes at 3.35 TB/s, whichever is
    larger."""
    t_ops = (rec_ops / rec_peak + proj_ops / proj_peak) * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gru_library_median(p, x: torch.Tensor, lengths: torch.Tensor,
                       bidirectional: bool = True) -> tuple[float, ...]:
    """:func:`gru_library_ms`'s reading (the smaller of its two timers)
    LIB_REPS times, after LIB_WARM_S seconds of the same calls that bring
    the card's clocks up: (median, lowest, highest) ms."""
    warm = time.perf_counter()
    while time.perf_counter() - warm < LIB_WARM_S:
        gru_library_ms(p, x, lengths, bidirectional)
    reps = sorted(min(gru_library_ms(p, x, lengths, bidirectional))
                  for _ in range(LIB_REPS))
    return reps[len(reps) // 2], reps[0], reps[-1]


def time_gru_probes(dev, card: str) -> dict:
    """Each probe kernel (f32 and bf16_mm), its plain version and cuDNN's
    layer at B=512 and B=1, T=32, D=180 (the scripts' inputs): the kernels
    on the held-stream timer (held_ms; CUDA events time the host under
    about 0.1 ms), the plain versions with CUDA events, the library layer
    as gru_library_median (packed once, TF32 off; its median, with the
    spread of its readings); each row's plan; each bound over this run's
    lengths with each part at the card's rate for its type
    (:func:`split_bound`). Beside P4: K2's one
    bidirectional layer on the same inputs (gru_proj then gru_seq, the
    port's yardstick), P4's function with the projection ahead (gru_proj
    on x and on x_flip, then gru_kstep_2w over both) and the dual kernel's
    timing stops (its projection, its recurrent products, or both left
    out). Fails if a kernel row is under its bound. Returns {kernel: {key:
    value}}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_gru
    from silent_speech_tpu_torch.ops import cuda_gru_proto as gp
    from silent_speech_tpu_torch.ops import gru as gru_ops
    from silent_speech_tpu_torch.scripts import bench_gru, proto_gru3

    T, H = PROBE_T, PROBE_H
    tc_peak = PEAK_F32_FLOPS + PEAK_TF32_FLOPS / 3
    out = {name: {} for name in PROBE_KERNELS}
    for B in (512, 1):
        x, L, layers = bench_gru.make_problem(B, T, dev)
        pf, pb = layers[0]["fwd"], layers[0]["bwd"]
        D, S = x.shape[-1], int(L.sum())
        x_flip = gru_ops.flip_padded(x, L)
        xp_f = x @ pf["wi"] + pf["bi"]
        xp2 = torch.cat([xp_f, x_flip @ pb["wi"] + pb["bi"]])
        L2 = L.repeat(2)
        wh2, bh2 = (torch.stack([pf[k], pb[k]]) for k in ("wh", "bh"))
        with full_f32():
            lib_uni = ("forward", gru_library_median(pf, x, L,
                                                     bidirectional=False))
            lib_bi = ("bidirectional", gru_library_median(pf, x, L))
        rec_ops, proj_ops = 2 * S * H * 3 * H, 2 * S * D * 3 * H
        k2p_peak = tc_peak if cuda_gru.proj_geometry(
            B * T, D, 3 * H).route == "large" else PEAK_F32_FLOPS
        rec_bytes = 4 * (B * T * 4 * H + H * 3 * H + 3 * H + B)
        proj_bytes = 4 * (B * T * (D + H) + (D + H) * 3 * H + 6 * H + B)
        cases = {  # kernel: (run(bf16), plain, recurrence ops, projection
            # ops, its rate, bytes, (library, ms), plan(bf16))
            "gru_kstep": (
                lambda bf16: gp.gru_sequence_kstep(
                    xp_f, L, pf["wh"], pf["bh"], bf16_mm=bf16,
                    impl="kernel"),
                lambda: gp.gru_recurrence_plain(xp_f, L, pf["wh"], pf["bh"]),
                rec_ops, 0, tc_peak, rec_bytes, lib_uni,
                lambda bf16: gp.rec_plan(B, 1, H, bf16_mm=bf16)),
            "gru_kstep_2w": (
                lambda bf16: gp.gru_sequence_kstep_2w(
                    xp2, L2, wh2, bh2, bf16_mm=bf16, impl="kernel"),
                lambda: torch.cat([gp.gru_recurrence_plain(
                    xp2[s * B:(s + 1) * B], L, wh2[s], bh2[s])
                    for s in (0, 1)]),
                2 * rec_ops, 0, tc_peak, 2 * rec_bytes, lib_bi,
                lambda bf16: gp.rec_plan(B, 2, H, bf16_mm=bf16)),
            "gru_fusedproj": (
                lambda bf16: proto_gru3.gru_sequence_fusedproj(
                    x, L, pf["wi"], pf["bi"], pf["wh"], pf["bh"],
                    impl="kernel"),
                lambda: gru_ops.gru_layer_single_direction(x, L, pf)[0],
                rec_ops, proj_ops, k2p_peak, proj_bytes, lib_uni, None),
            "gru_dual": (
                lambda bf16: gp.gru_layer_dual(x, x_flip, L, pf, pb,
                                               bf16_mm=bf16, impl="kernel"),
                lambda: gp.gru_layer_dual_plain(x, x_flip, L, pf, pb),
                2 * rec_ops, 2 * proj_ops, tc_peak,
                4 * (2 * B * T * (D + H) + 2 * ((D + H) * 3 * H + 6 * H)
                     + B), lib_bi,
                lambda bf16: gp.dual_plan(B, D, H, T, bf16_mm=bf16)),
        }
        sfx = "" if B == 512 else "_b1"
        for name, (run, plain, rops, pops, peak, nbytes, lib,
                   plan) in cases.items():
            r = out[name]
            r["ms" + sfx] = held_ms(lambda: run(False), dev)
            with full_f32():
                r["plain_ms" + sfx] = cuda_ms(plain, 5, warmup=1)
            r["bound_ms" + sfx], r["bound_by" + sfx] = split_bound(
                rops, PEAK_F32_FLOPS, pops, peak, nbytes)
            r["library_ms" + sfx] = lib[1][0]
            r["library_spread_ms" + sfx] = lib[1][1:]
            check_bound(f"{name} B={B}", r["ms" + sfx], r["bound_ms" + sfx])
            line = (f"  {name} B={B} T={T} D={D}: kernel {r['ms' + sfx]:.4f}"
                    f" ms, plain {r['plain_ms' + sfx]:.4f} ms, bound "
                    f"{r['bound_ms' + sfx]:.4f} ms ({r['bound_by' + sfx]}), "
                    f"torch.nn.GRU {lib[0]} layer (cuDNN, projection "
                    f"included, packed once, TF32 off) median {lib[1][0]:.4f}"
                    f" ms of {LIB_REPS} (spread {lib[1][1]:.4f}-"
                    f"{lib[1][2]:.4f}) ({'' if r['ms' + sfx] < lib[1][0] else 'NOT '}"
                    f"faster, x{lib[1][0] / r['ms' + sfx]:.2f})")
            if plan is not None:
                r["plan" + sfx] = plan(False)._asdict()
                line += f"; plan {plan_str(plan(False))}"
            if name != "gru_fusedproj":  # K2 has no bf16 build
                r["ms_bf16" + sfx] = held_ms(lambda: run(True), dev)
                r["bound_ms_bf16" + sfx] = split_bound(
                    rops, PEAK_BF16_FLOPS, pops, PEAK_BF16_FLOPS, nbytes)[0]
                check_bound(f"{name} bf16_mm B={B}", r["ms_bf16" + sfx],
                            r["bound_ms_bf16" + sfx])
                line += (f"; bf16_mm {r['ms_bf16' + sfx]:.4f} ms (bound "
                         f"{r['bound_ms_bf16' + sfx]:.4f}, the products at "
                         f"the bf16 rate; plan {plan_str(plan(True))})")
            print(line + f" {card}")
        pack = cuda_gru.pack_layer([(pf, False), (pb, True)])
        layer = [{"fwd": pf, "bwd": pb, "packed": pack}]
        wts = [cuda_gru.pack_wi_tc(p["wi"]) for p in (pf, pb)]

        def ahead():
            xp = torch.cat([cuda_gru.gru_proj(
                xx, p["wi"], p["bi"], impl="kernel", wt=wt)
                for xx, p, wt in ((x, pf, wts[0]), (x_flip, pb, wts[1]))])
            return gp.gru_sequence_kstep_2w(xp, L2, wh2, bh2, impl="kernel")
        r = out["gru_dual"]
        r["k2_layer_ms" + sfx] = held_ms(lambda: cuda_gru.bigru_kernel(
            x, L, layer, impl="kernel"), dev)
        r["proj_ahead_ms" + sfx] = held_ms(ahead, dev)
        r["stops_ms" + sfx] = {stop: held_ms(
            lambda: gp.gru_layer_dual_stop(x, x_flip, L, pf, pb, stop), dev)
            for stop in gp.STOPS}
        print(f"  beside gru_dual B={B} D={D}: K2's bidirectional layer "
              f"(gru_proj then gru_seq) {r['k2_layer_ms' + sfx]:.4f} ms; "
              "P4's function with the projection ahead (gru_proj on x and "
              f"x_flip, then gru_kstep_2w) {r['proj_ahead_ms' + sfx]:.4f} ms;"
              " gru_dual's timing stops (gru_dual_stop, the plan's launch) "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          r["stops_ms" + sfx].items()) + f" ms {card}")
    return out


def run_gru_probe_scripts() -> dict:
    """The main() of the four ported GRU scripts at B=512 and B=1, T=32,
    PROBE_ITERS timed calls a variant; launch counts from 0 over each
    script's two runs. Checks every f32 row within BAR_GRU of the plain
    scan and every bf16 row finite and within BAR_PROBE_BF16_ROW. Returns
    {script: launch counts}; raises on a failure."""
    import importlib

    from silent_speech_tpu_torch.ops import _kernels

    counts = {}
    for script in PROBE_SCRIPTS:
        mod = importlib.import_module(
            f"silent_speech_tpu_torch.scripts.{script}")
        _kernels.reset_launch_counts()
        for argv in ([f"iters={PROBE_ITERS}"],
                     ["1", str(PROBE_T), f"iters={PROBE_ITERS}"]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                res = mod.main(argv)
            print("".join(f"  | {line}\n" for line in
                          out.getvalue().splitlines()[:-1]), end="")
            for row in res["rows"]:
                bar = BAR_PROBE_BF16_ROW if "bf16" in row["name"] else BAR_GRU
                if not row["max_abs_err"] <= bar:
                    fail(f"{script} {argv}: row {row['name']} err "
                         f"{row['max_abs_err']:.3e} over {bar:g}")
        torch.cuda.synchronize()
        counts[script] = {k: v for k, v in _kernels.launch_counts().items()
                          if v}
        print(f"  {script}: launches over its B=512 and B=1 runs "
              f"{counts[script]}")
    want = {script: {"gru_proj", "gru_seq"}  # baselines
            for script in PROBE_SCRIPTS}
    for _, _, script, count in PROBE_KERNELS.values():
        want[script].add(count)
    for script, names in want.items():
        if any(not counts[script].get(n) for n in names):
            fail(f"{script}: a kernel of its path was not launched: "
                 f"{counts[script]}, expected {sorted(names)}")
    return counts


def parity_inputs(N: int, kind: str, rng, dev):
    """N random frames (the last two all-0 and all-255) split into classes,
    and packed or random (unpacked, proto_ablate's draws) WE, WO, bias."""
    from silent_speech_tpu_torch.ops import cuda_parity_cnn as pc
    roi = rng.integers(0, 256, (N, 48, 96), dtype=np.uint8)
    roi[-2], roi[-1] = 0, 255
    if kind == "packed":
        w = pc.pack_parity_conv1(
            rng.standard_normal((3, 3, 1, 8)).astype(np.float32) * 0.3,
            rng.standard_normal(8).astype(np.float32) * 0.1)
    else:
        w = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
             for sh in ((104, 128), (104, 128), (1, 384))]
    roi = torch.from_numpy(roi).to(dev)
    return roi, pc.split_classes(roi), [t.to(dev) for t in w]


def check_parity(dev, rng, errs: dict) -> None:
    """The parity kernel against its plain version (TF32 off) in both
    layouts at N in (16, FRONT_N) with packed and random weights, all-0
    and all-255 frames among them (the bars of the JAX scripts: BAR_PARITY,
    BAR_PARITY_REL of max|ref|), packed also against the plain conv1 +
    pool1; a second launch bitwise the first, the ablation's ``full``
    bitwise the kernel, and every stop of the ablation run once. Notes the
    largest errors in ``errs``; raises on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_parity_cnn as pc

    def close(name, label, got, ref, kind):
        if kind == "packed":
            err = check_close(f"{name} {label}", got, ref, BAR_PARITY)
            errs[name]["max_abs_err"] = max(errs[name]["max_abs_err"], err)
            return
        scale = ref.abs().max().item()
        err = check_close(f"{name} {label} (max|ref| {scale:.1f})", got, ref,
                          BAR_PARITY_REL * scale) / scale
        errs[name]["max_rel_err_random_weights"] = max(
            errs[name].get("max_rel_err_random_weights", 0.0), err)

    for N in (16, FRONT_N):
        for kind in ("packed", "random"):
            roi, xs, w = parity_inputs(N, kind, rng, dev)
            flat = [x.reshape(-1, 96) for x in xs]
            halves = pc.conv1pool1_parity(*xs, *w, impl="kernel")
            again = pc.conv1pool1_parity(*xs, *w, impl="kernel")
            one = pc.conv1pool1(*flat, *w, impl="kernel")
            full = pc.run(*flat, *w, mode="full", impl="kernel")
            torch.cuda.synchronize()
            with full_f32():
                ref = pc.parity_halves_plain(xs, *w)
            label = f"N={N} {kind} weights"
            for half, g, r in zip(("even", "odd"), halves, ref):
                close("conv1pool1_parity", f"{label} m-{half}", g, r, kind)
            close("conv1pool1", label, one,
                  pc.pooled1_from_quadrants(ref, N), kind)
            if not all(torch.equal(a, b) for a, b in zip(again, halves)):
                fail(f"conv1pool1_parity: two launches differ ({label})")
            if not all(torch.equal(a, b) for a, b in zip(full, halves)):
                fail(f"parity_ablate full differs from the kernel ({label})")
            print(f"  conv1pool1_parity {label}: two launches bitwise equal;"
                  " parity_ablate full bitwise the kernel")
            if kind == "packed":  # and the plain conv1 + pool1 itself
                k = torch.stack([torch.stack([w[0][dy * 34 + dx, :8]
                                              for dx in range(3)])
                                 for dy in range(3)])[:, :, None] * 255.0
                with full_f32():
                    conv = pc.ref_conv1pool1(roi, k, w[2][0, :8])
                check_close(f"conv1pool1 {label} vs plain conv1+pool1", one,
                            conv, BAR_PARITY)
            if N == FRONT_N and kind == "random":
                parity_controls(pc, xs, w, halves, ref, errs)
                for mode in pc.ABLATION_MODES:
                    out = pc.run(*flat, *w, mode=mode, impl="kernel")
                    torch.cuda.synchronize()
                    if [tuple(o.shape) for o in out] != [(N * 12, 384)] * 2:
                        fail(f"parity_ablate {mode}: shapes "
                             f"{[tuple(o.shape) for o in out]}")
                print(f"  parity_ablate: every stop ran at N={N} "
                      f"({', '.join(pc.ABLATION_MODES)})")


def parity_controls(pc, xs, w, halves, ref, errs: dict) -> None:
    """Random weights: the kernel's, the plain version's and its two
    controls' (one tensor-core sum over all K; W_hi's pass alone) largest
    difference from the float64 version, as shares of max|ref64|, and the
    controls' from the plain one; the one-pass control must miss
    BAR_PARITY_REL, or the bar could not tell it from the kernel."""
    patch = pc.parity_patches(xs).double()
    ref64 = pc.pool_halves(patch @ w[0].double(), patch @ w[1].double(),
                           w[2].double())
    del patch
    scale = max(r.abs().max().item() for r in ref64)

    def off(outs, want):
        return max((a.double() - b.double()).abs().max().item()
                   for a, b in zip(outs, want)) / scale

    e = errs["conv1pool1_parity"]
    e["rel_err64"], e["plain_rel_err64"] = off(halves, ref64), off(ref, ref64)
    for which in ("one_sum", "one_pass"):
        got = pc.control(*xs, *w, which)
        e[f"{which}_rel_err"] = off(got, ref)
        e[f"{which}_rel_err64"] = off(got, ref64)
    print(f"  conv1pool1_parity N={FRONT_N} random weights, max|err| / "
          f"max|ref|: kernel {e['rel_err64']:.3e} off float64 (the plain f32 "
          f"version {e['plain_rel_err64']:.3e}); one tensor-core sum over K "
          f"{e['one_sum_rel_err']:.3e} off plain, {e['one_sum_rel_err64']:.3e}"
          f" off float64; W_hi's pass alone {e['one_pass_rel_err']:.3e} off "
          f"plain (bar {BAR_PARITY_REL:g})")
    if not e["one_pass_rel_err"] > BAR_PARITY_REL:
        fail("conv1pool1_parity: W_hi's pass alone passes the random-weight "
             "bar, which then cannot tell it from the two passes")


def check_cnn_front(dev) -> dict:
    """The CNN-front prototypes' kernels against their plain versions (TF32
    off): the parity kernel (:func:`check_parity`); each probe stage's
    per-block value; K1's debug stops, live and standardized. Returns each
    kernel's largest errors ({name: {key: value}}); raises on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.models.bigru import init_roi_cnn
    from silent_speech_tpu_torch.ops import cuda_cnn
    from silent_speech_tpu_torch.ops import cuda_front_probe as fp

    rng = np.random.default_rng(SEED + 9)
    errs = {name: {"max_abs_err": 0.0} for name in FRONT_KERNELS}
    check_parity(dev, rng, errs)

    roi_np = rng.integers(0, 256, (FRONT_N, 48, 96), dtype=np.uint8)
    roi_np[0], roi_np[1] = 0, 255
    x = torch.from_numpy(roi_np.reshape(-1, 384))
    x_small = torch.from_numpy(rng.integers(0, 256, (FRONT_N, 4),
                                            dtype=np.uint8))
    pl = fp.plan()
    if (pl.slots, pl.smem, pl.threads) != fp.ring_geometry():
        fail(f"roi_front_probe: the ladder's plan {pl} is not its mirror")
    # ragged: below and above one wave
    ragged = (16 * ((pl.blocks - 1) // 16), 16 * (pl.blocks // 16 + 1))
    walks = {n: fp.frame_walk(n, pl.blocks) for n in (FRONT_N,) + ragged}
    print(f"  roi_front_probe ladder: plan {pl.blocks} blocks "
          f"({pl.blocks // pl.sms} an SM), {pl.slots} ring slots, {pl.smem} "
          "B, every rung; " + ", ".join(
              f"N={n} {len(w)} blocks of {len(w[0])} to {len(w[-1])} frames"
              for n, w in walks.items()))
    for stage in fp.STAGES:
        ns = (FRONT_N,) + (ragged if stage in fp.LADDER else ())
        for F in (fp.DMA_FRAMES if stage == "dma" else (1,)):
            for n in ns:
                xi = x_small if stage == "overlap_b" else x[:n * fp.HQ]
                got = fp.probe(stage, xi.to(dev), F).cpu()
                want = fp.probe_plain(stage, xi, F).double()
                err = (got.double() - want).abs()
                bar = fp.bar(stage, xi, F).double()
                print(f"  roi_front_probe {stage} F={F} N={n}: max "
                      f"difference per block {err.max().item():.3e} (bar: "
                      "1e-5 of each moment's sum of |terms|, 0 for integer "
                      "sums)")
                if (err > bar).any():
                    fail(f"roi_front_probe {stage} F={F} N={n}: "
                         f"{int((err > bar).sum())} blocks off the plain "
                         "version")
                e = errs["roi_front_probe"]
                e["max_abs_err"] = max(e["max_abs_err"], err.max().item())

    p = {k: {n: t.to(dev) for n, t in v.items()}
         for k, v in init_roi_cnn(32, torch.Generator().manual_seed(SEED + 9))
         .items()}
    roi = torch.from_numpy(roi_np).to(dev)
    for std in (False, True):
        for stop in cuda_cnn.DEBUG_STOPS:
            got = cuda_cnn.roi_cnn_fused(roi, p, standardize=std,
                                         impl="kernel", debug_stop=stop)
            torch.cuda.synchronize()
            with full_f32():
                ref = cuda_cnn.roi_cnn_debug_plain(roi, p, std, stop)
                bar = BAR_STOP_REL * cuda_cnn.roi_cnn_debug_plain(
                    roi, p, std, stop, absolute=True)
            err = (got - ref).abs()
            print(f"  roi_cnn_debug stop={stop} standardize={std}: max abs "
                  f"err {err.max().item():.3e}, largest share of its bar "
                  f"{(err / bar.clamp(min=1e-30)).max().item():.3f} (bar "
                  f"{BAR_STOP_REL:g} of each moment's sum of |terms|)")
            if not torch.isfinite(got).all() or (err > bar).any():
                fail(f"roi_cnn_debug stop={stop} standardize={std} off its "
                     "plain version")
            e = errs["roi_cnn_debug"]
            e["max_abs_err"] = max(e["max_abs_err"], err.max().item())
        got = cuda_cnn.roi_cnn_fused(roi, p, standardize=std, impl="kernel",
                                     debug_stop=None)
        with full_f32():
            ref = cuda_cnn.roi_cnn_plain(roi, p, std)
        check_close(f"roi_cnn debug_stop=None N={FRONT_N} standardize={std}",
                    got, ref, BAR_K1_STD if std else BAR_K1_LIVE)
    return errs


def time_parity(dev, card: str, rng, out: dict) -> torch.Tensor:
    """The parity kernel at N=FRONT_N, packed weights, on the held-stream
    timer: each of its three wrappers, the ablation's stops, the plain
    version (TF32 off) and the plain conv1 + ReLU + pool1; the bound at
    :data:`PARITY_PEAK` (a row over 100% of it fails), and beside it the
    bounds at 3xTF32's rate with the FMAs and at the FMA rate alone.
    Fills ``out``'s three parity rows; returns the frames."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_parity_cnn as pc
    from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness

    N = FRONT_N
    hold = harness.Args(N, dev, 20)

    def timed(fn, by: str) -> float:
        return harness.device_ms(fn, hold, cold=by == "bytes")

    roi, xs, w = parity_inputs(N, "packed", rng, dev)
    flat = [x.reshape(-1, 96) for x in xs]
    in_bytes, out_bytes = N * 48 * 96, 4 * N * 12 * 768
    w_bytes = 4 * (2 * 104 * 128 + 384)
    nbytes = in_bytes + out_bytes + w_bytes
    p_bound = bound_ms(2 * N * PARITY_MACS, nbytes, PARITY_PEAK)
    p_bound_3x = tc_bound(2 * N * PARITY_MACS, nbytes)[0]
    p_bound_fma = bound_ms(2 * N * PARITY_MACS, nbytes)[0]
    p_bound_taps = bound_ms(2 * N * 48 * 96 * 8 * 9, nbytes, PARITY_PEAK)[0]
    with full_f32():
        plain_ms = timed(lambda: pc.parity_halves_plain(xs, *w), p_bound[1])
        k = torch.randn(3, 3, 1, 8, device=dev)
        conv_ms = timed(lambda: pc.ref_conv1pool1(roi, k, w[2][0, :8]),
                        p_bound[1])
    cases = {
        "conv1pool1_parity": lambda: pc.conv1pool1_parity(*xs, *w,
                                                          impl="kernel"),
        "conv1pool1": lambda: pc.conv1pool1(*flat, *w, impl="kernel"),
        "parity_ablate": lambda: pc.run(*flat, *w, mode="full",
                                        impl="kernel"),
    }
    for name, fn in cases.items():
        r = out[name]
        r["ms"] = timed(fn, p_bound[1])
        r["plain_ms"], r["plain_conv_ms"] = plain_ms, conv_ms
        r["bound_ms"], r["bound_by"] = p_bound
        r["bound_ms_3xtf32"] = p_bound_3x
        r["bound_ms_f32_fma"] = p_bound_fma
        r["bound_ms_9_taps"] = p_bound_taps
        r["share_of_bound"] = check_bound(f"{name} N={N}", r["ms"],
                                          p_bound[0])
        r["library_ms"] = None
        print(f"  {name} N={N}: kernel {r['ms']:.4f} ms, plain (through WE, "
              f"WO) {plain_ms:.4f} ms, plain conv1+ReLU+pool1 (cuDNN, three "
              f"calls) {conv_ms:.4f} ms, bound {p_bound[0]:.4f} ms "
              f"({p_bound[1]}, FMAs and two TF32 passes together; at "
              f"3xTF32's rate {p_bound_3x:.4f}, at the FMA rate "
              f"{p_bound_fma:.4f}; the 9 useful taps alone "
              f"{p_bound_taps:.4f}), {r['share_of_bound']:.1%} of it; no "
              f"single PyTorch call computes it {card}")
    r = out["parity_ablate"]
    io_bound = bound_ms(0, in_bytes + out_bytes)
    r["bound_ms_io_only"] = io_bound[0]
    for mode in ("io_only", "widen_only", "halo_only", "no_dot"):
        fn = lambda: pc.run(*flat, *w, mode=mode, impl="kernel")
        r[f"ms_{mode}"] = timed(fn, p_bound[1])
        print(f"  parity_ablate {mode}: {r[f'ms_{mode}']:.4f} ms {card}")
    r = out["conv1pool1_parity"]
    for which in pc.CONTROLS:
        r[f"ms_{which}"] = timed(lambda: pc.control(*xs, *w, which),
                                 p_bound[1])
        print(f"  conv1pool1_parity control {which}: {r[f'ms_{which}']:.4f} "
              f"ms {card}")
    return roi


def time_cnn_front(dev, card: str) -> dict:
    """Each CNN-front kernel, its plain version and its bound at N=FRONT_N
    (TF32 off for the plain versions), the ablation's stops, the probe's
    stages, K1 and its debug stops. One device timer: CUDA events around a
    run of calls with the host's launches held out
    (``proto_parity_cnn.device_ms``: the micro-kernels run for less time
    than the host takes to launch a call), with the L2 evicted before each
    call where the bound is the bytes from device memory (the 37.75 MB of
    frames fit the 50 MB L2). Returns {kernel: {key: value}}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.models.bigru import init_roi_cnn
    from silent_speech_tpu_torch.ops import cuda_cnn
    from silent_speech_tpu_torch.ops import cuda_front_probe as fp
    from silent_speech_tpu_torch.ops import cuda_parity_cnn as pc
    from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness
    from silent_speech_tpu_torch.scripts import proto_parity_e2e

    N, it = FRONT_N, 20
    hold = harness.Args(N, dev, it)

    def timed(fn, by: str) -> float:
        return harness.device_ms(fn, hold, cold=by == "bytes")

    rng = np.random.default_rng(SEED + 10)
    out = {name: {} for name in FRONT_KERNELS}
    roi = time_parity(dev, card, rng, out)
    in_bytes = N * 48 * 96

    cnn = {k_: {n: t.to(dev) for n, t in v.items()}
           for k_, v in proto_parity_e2e.tiny_roi_cnn().items()}
    we, wo, bias = (t.to(dev) for t in pc.pack_parity_conv1(
        cnn["conv0"]["w"].cpu(), cnn["conv0"]["b"].cpu()))
    cflat = cuda_cnn.flat_weights(cnn)
    r = out["conv1pool1"]
    for key, fn in (
            ("e2e_parity_f32_ms", lambda: pc.roi_cnn_parity(
                cnn, roi, we, wo, bias, impl="kernel")),
            ("e2e_parity_bf16_ms", lambda: pc.roi_cnn_parity(
                cnn, roi, we, wo, bias, impl="kernel",
                compute_dtype=torch.bfloat16)),
            ("e2e_k1_ms", lambda: cuda_cnn.roi_cnn_fused(
                roi, cnn, impl="kernel", flat=cflat))):
        r[key] = timed(fn, "operations")
    print(f"  the whole CNN N={N}: parity front + cuDNN back half f32 "
          f"{r['e2e_parity_f32_ms']:.4f} ms, bf16 {r['e2e_parity_bf16_ms']:.4f}"
          f" ms; K1 {r['e2e_k1_ms']:.4f} ms {card}")

    x = roi.reshape(-1, 384)
    x_small = torch.from_numpy(rng.integers(0, 256, (N, 4), dtype=np.uint8)
                               ).to(dev)
    r = out["roi_front_probe"]
    for stage in fp.STAGES:
        for F in (fp.DMA_FRAMES if stage == "dma" else (1,)):
            xi = x_small if stage == "overlap_b" else x
            key = stage + ("" if F == 1 else f"_f{F}")
            macs = N * fp.THREADS * fp.CHAIN_ACC * fp.CHAIN_LEN \
                if stage.startswith("overlap") else 0
            blocks = N // F
            b_ms, b_by = bound_ms(
                2 * macs, (0 if stage == "overlap_b" else in_bytes)
                + 4 * blocks * (1 if stage in fp.SCALAR else 3))
            r[f"bound_ms_{key}"], r[f"bound_by_{key}"] = b_ms, b_by
            r[f"ms_{key}"] = timed(
                lambda: fp.probe(stage, xi, F), b_by)
            r[f"share_of_bound_{key}"] = check_bound(
                f"roi_front_probe {key}", r[f"ms_{key}"], b_ms)
            print(f"  roi_front_probe {key}: {r[f'ms_{key}']:.4f} ms"
                  f"{' (cold L2)' if b_by == 'bytes' else ''}, bound "
                  f"{b_ms:.4f} ms ({b_by}), "
                  f"{r[f'share_of_bound_{key}']:.1%} of it {card}")
    r["row"] = "front"  # the live front's rung
    r["ms"], r["bound_ms"], r["bound_by"] = \
        r["ms_front"], r["bound_ms_front"], r["bound_by_front"]
    r["plain_ms"] = timed(lambda: fp.probe_plain("front", x), "bytes")
    r["library_ms"] = None
    print(f"  roi_front_probe front: plain {r['plain_ms']:.4f} ms {card}")

    p = {k_: {n: t.to(dev) for n, t in v.items()}
         for k_, v in init_roi_cnn(32, torch.Generator().manual_seed(SEED + 10))
         .items()}
    pflat = cuda_cnn.flat_weights(p)
    r = out["roi_cnn_debug"]
    r["k1_ms"] = timed(lambda: cuda_cnn.roi_cnn_fused(
        roi, p, impl="kernel", flat=pflat), "operations")
    io = in_bytes + 4 * N * 32 + 4 * pflat.numel()
    for stop in cuda_cnn.DEBUG_STOPS:
        b_ms, b_by = k1_bound(N, STOP_MACS[stop], io)
        r[f"bound_ms_{stop}"], r[f"bound_by_{stop}"] = b_ms, b_by
        r[f"ms_{stop}"] = timed(
            lambda: cuda_cnn.roi_cnn_fused(roi, p, impl="kernel", flat=pflat,
                                           debug_stop=stop), b_by)
        r[f"share_of_bound_{stop}"] = check_bound(
            f"roi_cnn_debug stop={stop}", r[f"ms_{stop}"], b_ms)
    with full_f32():
        r["plain_ms"] = timed(lambda: cuda_cnn.roi_cnn_debug_plain(
            roi, p, False, "load"), "bytes")
    r["ms"], r["bound_ms"], r["bound_by"] = \
        r["ms_load"], r["bound_ms_load"], r["bound_by_load"]
    r["library_ms"] = None
    print(f"  K1 N={N}: {r['k1_ms']:.4f} ms; debug stops " + ", ".join(
              f"{s} {r['ms_' + s]:.4f} (bound {r['bound_ms_' + s]:.4f}, "
              f"{r['bound_by_' + s]})" for s in cuda_cnn.DEBUG_STOPS)
          + f" ms (cold L2 where bound by bytes); plain stop=load "
          f"{r['plain_ms']:.4f} ms {card}")
    return out


def run_cnn_front_scripts() -> dict:
    """The main() of the four CNN-front scripts at N=FRONT_N, FRONT_ITERS
    timed calls a row (each checks itself and raises over its bars); the
    launch counts from 0 over each script's run. Returns {script: launch
    counts}; raises if a kernel of a script's path was not launched."""
    import importlib

    from silent_speech_tpu_torch.ops import _kernels

    counts = {}
    for script in FRONT_SCRIPTS:
        mod = importlib.import_module(
            f"silent_speech_tpu_torch.scripts.{script}")
        _kernels.reset_launch_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.main([str(FRONT_N), f"iters={FRONT_ITERS}"])
        torch.cuda.synchronize()
        print("".join(f"  | {line}\n" for line in
                      out.getvalue().splitlines()[:-1]), end="")
        counts[script] = {k: v for k, v in _kernels.launch_counts().items()
                          if v}
        print(f"  {script}: launches over its N={FRONT_N} run "
              f"{counts[script]}")
    want = {script: set() for script in FRONT_SCRIPTS}
    for name, (_, _, script) in FRONT_KERNELS.items():
        want[script].add(name)
    want["proto_parity_e2e"].add("roi_cnn")
    want["probe_front"].add("roi_cnn")
    for script, names in want.items():
        if any(not counts[script].get(n) for n in names):
            fail(f"{script}: a kernel of its path was not launched: "
                 f"{counts[script]}, expected {sorted(names)}")
    return counts


def check_rate_probes(dev) -> dict:
    """The rate probes' kernels against their plain versions on the card
    (TF32 off): MR at the six probe shapes (reps 64, grid 64) and at small
    ragged ones (reps 9, grid 2), within 4 sqrt(reps K) 2^-24 of each
    element's sum of |terms| (ops/tf32_bars.BAR_DEPTH); DC in every mode
    at K=384 and 512, 256 steps and 3 (int8 / int8i also at a partial last
    sweep of their persistent grid, :func:`check_dc_s8`), its check
    instantiation's output and moments bitwise for int8 / int8i and within
    1e-5 (f32) or 2e-2 (bf16,
    rounding flips) of each value's sum of |terms|
    (ops/cuda_dot_chain.compare), in bf16 its traced rows product by
    product (ops/cuda_dot_chain.check_rounding, with two controls that must
    fail it: the chain held in f32 and in f16 between products), and the
    timed instantiation's output bitwise the check instantiation's; LP's
    nine bodies (:func:`check_lp`). Returns {kernel: {key: value}}; raises
    on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_dot_chain as dc
    from silent_speech_tpu_torch.ops import cuda_mm_rate as mr

    errs = {name: {"max_abs_err": 0.0, "max_share_of_bar": 0.0}
            for name in RATE_KERNELS}

    def note(name, label, r):
        e = errs[name]
        e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
        e["max_share_of_bar"] = max(e["max_share_of_bar"], r["share_of_bar"])
        print(f"  {name} {label}: max difference {r['max_abs_err']:.3e}, "
              f"{r['share_of_bar']:.3f} of the bar")

    with torch.no_grad(), full_f32():
        shapes = [(M, K, N, mr.REPS, mr.GRID) for M, K, N, _ in mr.SHAPES]
        shapes += [(M, K, N, 9, 2) for M, K, N in RATE_SMALL_MM]
        for M, K, N, reps, grid in shapes:
            a, b = mr.make_problem(M, K, N, dev)
            note("mm_rate", f"({M},{K},{N}) reps={reps} grid={grid}",
                 mr.check(a, b, reps, grid))
            pl, geo = mr.plan(M, K, N, grid), mr.geometry(M, K, N, grid)
            if (pl.bn, pl.items, pl.smem, pl.stages, pl.threads) != \
                    (geo.bn, geo.items, geo.smem, geo.stages, geo.threads):
                fail(f"mm_rate ({M},{K},{N}): plan {pl} is not its mirror "
                     f"{geo}")
            if not torch.equal(mr.mm_rate(a, b, reps, grid),
                               mr.mm_rate(a, b, reps, grid)):
                fail(f"mm_rate ({M},{K},{N}): two launches differ")
            print(f"    plan BN {pl.bn}, {pl.items} items on {pl.blocks} "
                  f"blocks ({pl.slots} at once), {pl.smem} B; two launches "
                  "bitwise equal")
        rng = np.random.default_rng(SEED + 11)
        check_dc_s8(dev, rng, note)
        for steps in (dc.GRID, 3):
            x = torch.from_numpy(rng.integers(0, 256, (steps * 8, 128),
                                              dtype=np.uint8)).to(dev)
            for K in dc.KS:
                for mode in ("f32", "bf16"):
                    w = dc.make_weights(mode, K).to(dev)
                    note("dot_chain", f"{mode} K={K} steps={steps}",
                         dc.check(x, w, mode))
                    if mode == "bf16":
                        for keep in (torch.float32, torch.float16):
                            bad = dc.rounding_outside(
                                dc.trace_plain(x, w, keep), x, w)
                            print(f"  dot_chain bf16 K={K} steps={steps}, "
                                  f"control held in {keep}: {bad} traced "
                                  "values outside their windows")
                            if not bad:
                                fail(f"dot_chain bf16: the control held in "
                                     f"{keep} passed the rounding check")
                        continue
                    packed = dc.pack_weights(w, mode)
                    want = dc.dot_chain(x, w, mode, packed=packed)
                    if not torch.equal(want, dc.dot_chain(x, w, mode,
                                                          packed=packed)):
                        fail(f"dot_chain f32 K={K}: two launches differ")
                    pl, geo = dc.plan(K, mode="f32"), dc.f32_geometry(K)
                    if (pl.cluster, pl.stages, pl.smem, pl.chunk) != \
                            (geo.cluster, geo.units, geo.smem, geo.unit):
                        fail(f"dot_chain f32 K={K}: plan {pl} is not its "
                             f"mirror {geo}")
                    print(f"    f32 plan: clusters of {pl.cluster}, "
                          f"{pl.stages} units of {pl.chunk} B, {pl.smem} B, "
                          f"{pl.clusters} clusters at once; two launches "
                          "bitwise equal")
        check_lp(dev, rng, errs["layout_micro"])
    return errs


def check_dc_s8(dev, rng, note) -> None:
    """DC's s8 kernel (int8, int8i) at K=384 and 512: its plan against its
    mirror (ops/cuda_dot_chain.s8_geometry), then at 256 steps and at two
    ragged step counts that leave its persistent grid a partial last sweep
    (3: most warpgroups idle; one more step than a sweep holds), its check
    instantiation's output and moments bitwise the plain version's
    (ops/cuda_dot_chain.check, which also holds the timed instantiation
    bitwise the checked one), and two launches of each bitwise equal."""
    from silent_speech_tpu_torch.ops import cuda_dot_chain as dc

    for K in dc.KS:
        pl, geo = dc.plan(K, mode="int8"), dc.s8_geometry(K)
        if (pl.cluster, pl.stages, pl.smem, pl.chunk, pl.threads) != \
                (geo.cluster, 1, geo.smem, geo.w_bytes, dc.S8_THREADS):
            fail(f"dot_chain s8 K={K}: plan {pl} is not its mirror {geo}")
        slots = pl.clusters * dc.S8_WARPGROUPS
        steps_all = (dc.GRID, 3, slots // dc.TILES + 1)
        walks = [dc.s8_walk(st, pl.clusters) for st in steps_all]
        print(f"    s8 plan K={K}: clusters of {pl.cluster}, {pl.clusters} "
              f"at once ({slots} warpgroup slots), {pl.smem} B, W^T "
              f"{pl.chunk} B a block; steps {steps_all} leave "
              + ", ".join(f"{sum(len(s) == len(w[0]) for s in w)} of "
                          f"{len(w)}" for w in walks)
              + " launched slots a last sweep")
        for steps in steps_all:
            x = torch.from_numpy(rng.integers(0, 256, (steps * 8, 128),
                                              dtype=np.uint8)).to(dev)
            for mode in ("int8", "int8i"):
                w = dc.make_weights(mode, K).to(dev)
                packed = dc.pack_weights(w, mode)
                note("dot_chain", f"{mode} K={K} steps={steps}",
                     dc.check(x, w, mode, packed=packed))
                out, mom, _ = dc.dot_chain(x, w, mode, packed=packed,
                                           check=True)
                out2, mom2, _ = dc.dot_chain(x, w, mode, packed=packed,
                                             check=True)
                timed = dc.dot_chain(x, w, mode, packed=packed)
                if not (torch.equal(out, out2) and torch.equal(mom, mom2)
                        and torch.equal(timed, dc.dot_chain(
                            x, w, mode, packed=packed))):
                    fail(f"dot_chain {mode} K={K} steps={steps}: two "
                         "launches differ")
        print(f"    s8 K={K}: every check twice bitwise equal")


def partial_sweep_steps(lm) -> int:
    """The fewest steps (at least 3) at which every moving LP body's
    launch leaves a partial last sweep of its persistent blocks
    (more units than blocks, not a multiple of them)."""
    for steps in range(3, 200):
        plans = [lm.move_plan(b, steps) for b in lm.MOVING]
        if all(p.units > p.blocks and p.units % p.blocks for p in plans):
            return steps
    fail("layout_micro: no step count below 200 leaves every moving body "
         "a partial last sweep")


def check_lp(dev, rng, e: dict) -> None:
    """LP's nine bodies at 512 steps, 2, and a step count that leaves the
    moving bodies' persistent blocks a partial last sweep
    (:func:`partial_sweep_steps`): bitwise their plain versions but the
    product (scripts/mosaic_micro.check_body), the unaligned body on its
    written lanes with zeros in the rest; the product body's copied lanes
    bitwise, its product within 4 sqrt(512) 2^-24 of each sum of |terms| and
    within the float64 bar of ops/cuda_layout_micro.compare_product, which one
    TF32 pass (cuda_layout_micro.one_pass, the control) must fail. Notes
    the largest errors in ``e``; raises on a failure."""
    from silent_speech_tpu_torch.ops import cuda_layout_micro as lm
    from silent_speech_tpu_torch.scripts import mosaic_micro

    partial = partial_sweep_steps(lm)
    for body in lm.MOVING:
        pl = lm.move_plan(body, partial)
        big = lm.move_plan(body, lm.STEPS)
        print(f"  layout_micro {body} plan: {pl.route}, blocks of "
              f"{pl.threads}; {big.units} units on {big.blocks} blocks at "
              f"{lm.STEPS} steps, {pl.units} on {pl.blocks} at {partial}")
    for steps in (lm.STEPS, 2, partial):
        x = torch.from_numpy(rng.standard_normal((steps * lm.R, lm.L))
                             .astype(np.float32)).to(dev)
        for body in lm.BODIES:
            err = mosaic_micro.check_body(body, x)
            e["max_abs_err"] = max(e["max_abs_err"], err)
            print(f"  layout_micro {body} steps={steps}: max difference "
                  f"{err:.3e}" + ("" if body == lm.MATMUL else " (bitwise)"))
        r = lm.compare_product(lm.layout(lm.MATMUL, x), x)
        control = lm.measure_product(lm.one_pass(x), x)
        for key, v in (("product_share_of_bar", r["share_of_bar"]),
                       ("product_share_of_bar64", r["share_of_bar64"]),
                       ("product_max_abs_err64", r["max_abs_err64"])):
            e[key] = max(e.get(key, 0.0), v)
        print(f"  layout_micro {lm.MATMUL} steps={steps}: product "
              f"{r['share_of_bar']:.3f} of the f32 bar, "
              f"{r['share_of_bar64']:.3f} of the float64 bar (max "
              f"difference {r['max_abs_err64']:.3e}); lanes "
              f"{lm.MM_N}..{lm.L - 1} bitwise; one TF32 pass "
              f"{control['share_of_bar64']:.3f} of the float64 bar")
        if not control["share_of_bar64"] > 1.0:
            fail(f"layout_micro {lm.MATMUL}: one TF32 pass passes the "
                 "float64 bar, which then cannot tell it from 3xTF32")
        del x


def time_lp_moves(dev, card: str) -> dict:
    """LP's moving bodies at 512 steps on the held-stream timer, the L2
    evicted before each call (the bytes bind them), twice, beside the
    body's library call where there is one (``clone`` for copy and
    aligned_128lane_x6), in turns: library, kernel, kernel, library.
    Returns {body: {key: value}}: the kernel's mean and two times, the
    library's, the bound, the route."""
    from silent_speech_tpu_torch.ops import cuda_layout_micro as lm
    from silent_speech_tpu_torch.scripts import proto_parity_cnn as harness

    steps = lm.STEPS
    hold = harness.Args(steps, dev, 10)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (steps * lm.R, lm.L)).astype(np.float32)).to(dev)
    out = {}
    with torch.no_grad():
        for body in lm.MOVING:
            b_ms = bound_ms(0, lm.bytes_moved(body, steps))[0]
            kernel = lambda body=body: lm.layout(body, x)
            lib = (lambda body=body: lm.library(body, x)) \
                if lm.library(body, x) is not None else None
            order = (lib, kernel, kernel, lib) if lib else (kernel, kernel)
            times = [(fn is lib, harness.device_ms(fn, hold, cold=True))
                     for fn in order]
            mine = [t for is_lib, t in times if not is_lib]
            libs = [t for is_lib, t in times if is_lib]
            r = {"bound_ms": b_ms, "bound_by": "bytes",
                 "route": lm.move_plan(body, steps).route,
                 "ms": statistics.mean(mine), "ms_each": mine,
                 "library_ms": statistics.mean(libs) if libs else None,
                 "library_ms_each": libs or None}
            r["share_of_bound"] = check_bound(f"layout_micro {body}",
                                              r["ms"], b_ms)
            out[body] = r
            print(f"  layout_micro {body} ({r['route']}): " + " / ".join(
                f"{t:.4f}" for t in mine) + f" ms; bound {b_ms:.4f} ms "
                f"({r['share_of_bound']:.1%})" + (
                    "" if lib is None else "; library " + " / ".join(
                        f"{t:.4f}" for t in libs) + " ms") + f" {card}")
    del x
    return out


def run_rate_probe_scripts(card: str) -> tuple[dict, dict]:
    """The three rate probes' scripts at their full size (probe_int8: 256
    steps, K=384 and 512; bench_fused_cnn: its mxu probe, main and ftile at
    N=8192; mosaic_micro: 512 steps), RATE_ITERS timed calls a row (each
    checks its kernel against its plain version and raises over its bars;
    bench_fused_cnn's mxu rows take at most 2); the launch counts from 0
    over each script's run. Each rate probe row gives its kernel's time,
    its bound, its plain version's time and its library row (TF32 off);
    a row above 100% of its bound fails: the bound is the least time the
    card can take, so a faster row did less work than the function asks.
    Returns ({script: launch counts}, {kernel: the kernels line's keys and
    its rows}); raises if a kernel of a script's path was not launched."""
    import importlib

    from silent_speech_tpu_torch.ops import _kernels

    counts, reports = {}, {}
    for script in RATE_SCRIPTS:
        mod = importlib.import_module(
            f"silent_speech_tpu_torch.scripts.{script}")
        parts = ([mod.probe_mxu, mod.main, mod.sweep_f_tile]
                 if script == "bench_fused_cnn" else [mod.main])
        _kernels.reset_launch_counts()
        reports[script] = []
        for part in parts:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                reports[script].append(part([f"iters={RATE_ITERS}"]))
            torch.cuda.synchronize()
            print("".join(f"  | {line}\n" for line in
                          out.getvalue().splitlines()[:-1]), end="")
        counts[script] = {k: v for k, v in _kernels.launch_counts().items()
                          if v}
        print(f"  {script}: launches over its full-size run {counts[script]}")
    want = {script: set() for script in RATE_SCRIPTS}
    for name, (_, _, script, _) in RATE_KERNELS.items():
        want[script].add(name)
    want["bench_fused_cnn"] |= {"roi_cnn", "roi_cnn_bf16", "roi_cnn_debug",
                                "gru_seq"}
    for script, names in want.items():
        if any(not counts[script].get(n) for n in names):
            fail(f"{script}: a kernel of its path was not launched: "
                 f"{counts[script]}, expected {sorted(names)}")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rates = {}
    for name, (_, _, script, first) in RATE_KERNELS.items():
        rows = {r["name"].removeprefix("mxu_"): r
                for r in reports[script][0]["rows"]}
        for key, r in rows.items():
            share = r["bound_ms"] / r["ms"]
            r["share_of_bound"] = share
            factor = "" if r["library_ms"] is None else (
                f" (the kernel {r['library_ms'] / r['ms']:.2f}x the "
                "library's speed)")
            print(f"  {name} {key}: {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {share:.1%} of "
                  f"it; plain {r['plain_ms']:.4f} ms; library "
                  + ("none: no single call" if r["library_ms"] is None
                     else f"{r['library_ms']:.4f} ms") + f"{factor} {card}")
            if share > 1.0:
                fail(f"{name} {key}: {r['ms']:.4f} ms is {share:.1%} of its "
                     f"bound {r['bound_ms']:.4f} ms: it did less work than "
                     "the function")
        rates[name] = {**{k: rows[first][k] for k in keys}, "row": first,
                       "rows": {k: {c: v for c, v in r.items() if c != "name"}
                                for k, r in rows.items()}}
    rows = rates["dot_chain"]["rows"]
    for K in (384, 512):  # what probe_int8 asks: does int8 beat bf16?
        b16 = rows[f"bf16_k{K}"]["ms"]
        print(f"  dot_chain s8 K={K}: " + "; ".join(
            f"{m} {rows[f'{m}_k{K}']['ms']:.4f} ms, "
            f"{rows[f'{m}_k{K}']['share_of_bound']:.1%} of the int8 bound, "
            f"{b16 / rows[f'{m}_k{K}']['ms']:.2f}x the bf16 chain's speed, "
            f"14 _int_mm {rows[f'{m}_k{K}']['library_ms']:.4f} ms"
            for m in ("int8", "int8i")) + f"; bf16 {b16:.4f} ms {card}")
    return counts, rates


def check_bwd_dots(dev) -> dict:
    """The backward-dot kernels against their plain versions on the card
    (TF32 off) at the small ragged shape BWD_SMALL (every kind; tt and nn
    also in dots3's form, one 24-row tile over 7 steps), within 4 sqrt(n)
    2^-24 of each element's sum of |terms| (ops/cuda_bwd_dots.compare; nt's
    tail rows exact zeros), the tensor-core kinds (all five: 3xTF32) also
    within compare's float64 bar; xp bitwise tt at BWD_SMALL and at
    dots2's full shapes (m 384 and 1536); every kind twice on the same
    full-size inputs, bitwise equal; one TF32 pass
    (cuda_bwd_dots.one_pass) outside the float64 bar, the control that the
    bar tells 3xTF32 from it, where compare's derivation says it can: tt's
    and xp's dots2 (= dots1) shape, nn's dots3 shape, nt's (384, 512, 256)
    and BWD_SMALL (check_nt: dots1's other two), base at BWD_SMALL (at its
    full shape the share is printed, not held); the five kernels' launch
    plans at the full shapes. The scripts' rows hold every kernel at the
    full shapes. Returns {kernel: {max_abs_err, max_share_of_bar[,
    max_share_of_bar64, plan]}}; raises on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_bwd_dots as bd

    errs = {name: {"max_abs_err": 0.0, "max_share_of_bar": 0.0}
            for name in BWD_KERNELS}

    def note(kind, label, r):
        e = errs[BWD_KIND_KERNEL[kind]]
        e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
        e["max_share_of_bar"] = max(e["max_share_of_bar"], r["share_of_bar"])
        tail = ""
        if "share_of_bar64" in r:
            e["max_share_of_bar64"] = max(e.get("max_share_of_bar64", 0.0),
                                          r["share_of_bar64"])
            tail = f", {r['share_of_bar64']:.3f} of the float64 bar"
        print(f"  {BWD_KIND_KERNEL[kind]} {kind} {label}: max difference "
              f"{r['max_abs_err']:.3e}, {r['share_of_bar']:.3f} of the bar"
              f"{tail}")

    rng = np.random.default_rng(SEED + 12)
    rows, m, K, N = BWD_SMALL
    with torch.no_grad(), full_f32():
        p, dy, w = (bd.draw(rng, s, dev) for s in ((rows, K), (rows, N),
                                                    (K, N)))
        for kind, a, b in (("tt", p, dy), ("xp", p, dy), ("nt", dy, w),
                           ("base", p, w)):
            note(kind, f"rows={rows} m={m} K={K} N={N}",
                 bd.check(kind, a, b, m=m))
        note("tt", f"one {m}-row tile, 7 steps", bd.check(
            "tt", p[:m].contiguous(), dy[:m].contiguous(), m=m, steps=7))
        note("nn", f"({K},{m})x({m},{N}), 7 steps", bd.check(
            "nn", p[:m].T.contiguous(), dy[:m].contiguous(), steps=7))
        out = bd.bwd_dot_nt(dy, w, m)
        if not torch.equal(out[rows // m * m:],
                           torch.zeros_like(out[rows // m * m:])):
            fail("bwd_dot_nt: the tail rows past G m are not zeros")
        small = {"base": (p, w, {"m": m}), "nt": (dy, w, {"m": m})}
        xp_is_tt(p, dy, m, "BWD_SMALL")
        p, dy, w = (bd.draw(rng, s, dev) for s in ((bd.ROWS, 512),
                                                    (bd.ROWS, 256),
                                                    (512, 256)))
        pk = p[:384].T.contiguous()
        d3 = dy[:384].contiguous()
        full = {"tt": (p, dy, {"m": 384}), "xp": (p, dy, {"m": 384}),
                "base": (p, w, {"m": 384}),
                "nn": (pk, d3, {"steps": bd.STEPS}),
                "nt": (dy, w, {"m": 384})}
        for kind, (a, b, kw) in full.items():
            one, two = bd.run(kind, a, b, **kw), bd.run(kind, a, b, **kw)
            torch.cuda.synchronize()
            if not torch.equal(one, two):
                fail(f"bwd_dot {kind}: two launches on the same inputs "
                     "differ")
            print(f"  {BWD_KIND_KERNEL[kind]} {kind} {tuple(a.shape)} x "
                  f"{tuple(b.shape)} {kw}: two launches bitwise equal")
        for m_full in (384, 1536):
            xp_is_tt(p, dy, m_full, "dots2's full shape")
        for kind in bd.TC_KINDS:
            shape = {"tt": (512, 256, bd.ROWS // 384),
                     "xp": (512, 256, bd.ROWS // 384),
                     "base": (384, 256, bd.ROWS // 384),
                     "nn": (512, 256, bd.STEPS),
                     "nt": (bd.ROWS // 384 * 384, 512, 256)}[kind]
            pl = bd.plan(kind, *shape)
            errs[BWD_KIND_KERNEL[kind]]["plan"] = pl._asdict()
            print(f"  {BWD_KIND_KERNEL[kind]} {kind} plan at {shape}: {pl}")
            if pl.resident_per_sm < 1:
                fail(f"bwd_dot {kind}: its block does not fit an SM ({pl})")
            controls = [("full size", full[kind])] + (
                [("BWD_SMALL", small[kind])] if kind in small else [])
            for where, (a, b, kw) in controls:
                r = bd.measure(kind, bd.one_pass(kind, a, b, **kw), a, b,
                               **kw)
                held = kind != "base" or where == "BWD_SMALL"
                print(f"  {BWD_KIND_KERNEL[kind]} {kind} {where} {kw}: one "
                      f"TF32 pass {r['share_of_bar']:.3f} of the f32 bar, "
                      f"{r['share_of_bar64']:.3f} of the float64 bar"
                      + ("" if held else " (not held: compare's derivation "
                         "puts it under any bar scaled by the sum of "
                         "|terms| at this shape)"))
                if held and not r["share_of_bar64"] > 1.0:
                    fail(f"bwd_dot {kind} {where}: one TF32 pass passes the "
                         "float64 bar, which then cannot tell it from "
                         "3xTF32")
    return errs


# dots1's three nt shapes (m, K, N), proto_bwd_dots.SHAPES
NT_SHAPES = ((192, 104, 256), (384, 512, 256), (384, 256, 512))


def check_nt(dev) -> dict:
    """nt at dots1's three full shapes (98,304 rows): one TF32 pass
    (cuda_bwd_dots.one_pass) outside compare's float64 bar at each (the
    control; check_bwd_dots holds it at BWD_SMALL too), and the 3-pass
    stop (``bwd_dot_nt_stop``) bitwise bwd_dot_nt. Returns
    {"control_share_of_bar64": {shape: share}}; raises on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_bwd_dots as bd

    rng = np.random.default_rng(SEED + 14)
    out = {"control_share_of_bar64": {}}
    with torch.no_grad(), full_f32():
        for m, K, N in NT_SHAPES:
            dy, w = bd.draw(rng, (bd.ROWS, N), dev), bd.draw(rng, (K, N), dev)
            key = f"{m}x{K}x{N}"
            if not torch.equal(bd.bwd_dot_nt_stop(dy, w, m),
                               bd.bwd_dot_nt(dy, w, m)):
                fail(f"bwd_dot_nt_stop at {key} is not bwd_dot_nt bitwise")
            control = bd.measure("nt", bd.one_pass("nt", dy, w, m=m), dy, w,
                                 m=m)
            out["control_share_of_bar64"][key] = control["share_of_bar64"]
            print(f"  bwd_dot_nt {key}: the 3-pass stop bitwise bwd_dot_nt; "
                  f"one TF32 pass {control['share_of_bar64']:.3f} of the "
                  "float64 bar")
            if not control["share_of_bar64"] > 1.0:
                fail(f"bwd_dot nt {key}: one TF32 pass passes the float64 "
                     "bar, which then cannot tell it from 3xTF32")
            del dy, w
    return out


def time_nt_variants(dev, card: str) -> dict:
    """bwd_dot_nt at dots1's three shapes with the host's launches held out:
    the route, its kernel in one TF32 pass (hi*hi alone, another function:
    what the second and third passes cost), beside ``dy[:Gm] @ w.T`` (f32,
    TF32 off). Returns {shape: {variant: ms}}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_bwd_dots as bd

    rng = np.random.default_rng(SEED + 15)
    out = {}
    with torch.no_grad(), full_f32():
        for m, K, N in NT_SHAPES:
            dy, w = bd.draw(rng, (bd.ROWS, N), dev), bd.draw(rng, (K, N), dev)
            Gm = bd.ROWS // m * m
            row = {"route": held_ms(lambda: bd.bwd_dot_nt(dy, w, m), dev,
                                    RATE_ITERS),
                   "one_pass": held_ms(
                       lambda: bd.bwd_dot_nt_stop(dy, w, m, passes=1), dev,
                       RATE_ITERS),
                   "library_ms": held_ms(lambda: torch.matmul(dy[:Gm], w.T),
                                         dev, RATE_ITERS)}
            out[f"{m}x{K}x{N}"] = row
            print(f"  bwd_dot_nt rows={bd.ROWS} (m,K,N)=({m},{K},{N}): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items())
                  + f" {card}")
            del dy, w
    return out


def xp_is_tt(p: torch.Tensor, dy: torch.Tensor, m: int, where: str) -> None:
    """bwd_dot_xp(p, dy, m) must be bitwise bwd_dot_tt(p, dy, m): the
    transpose only moves values; raises otherwise."""
    from silent_speech_tpu_torch.ops import cuda_bwd_dots as bd

    xp, tt = bd.bwd_dot_xp(p, dy, m), bd.bwd_dot_tt(p, dy, m)
    torch.cuda.synchronize()
    if not torch.equal(xp, tt):
        fail(f"bwd_dot_xp m={m} ({where}) is not bwd_dot_tt bitwise: max "
             f"difference {(xp - tt).abs().max().item():.3e}")
    print(f"  bwd_dot_xp {tuple(p.shape)} x {tuple(dy.shape)} m={m} "
          f"({where}): bitwise bwd_dot_tt")


def run_bwd_dot_scripts(card: str) -> tuple[dict, dict]:
    """The three backward-dot scripts at full size (98,304 rows; dots3 512
    steps), RATE_ITERS timed calls a row (each row first holds its kernel's
    output against the plain version and raises over its bar); the launch
    counts from 0 over each script's run; xp / tt at each of dots2's m,
    the transposing stage's cost (``xp_over_tt`` in xp's rates). A row
    above 100% of its bound fails: the bound is the least time the card
    can take, so a faster row did less work than the function asks (a
    product hoisted out of dots3's steps, or base's colsum(p) @ w).
    Returns ({script: launch counts}, {kernel: the kernels line's keys, its
    rows, its launches over the three runs}); raises if a kernel of a
    script's path was not launched."""
    import importlib

    from silent_speech_tpu_torch.ops import _kernels

    counts, reports = {}, {}
    for script in BWD_SCRIPTS:
        mod = importlib.import_module(
            f"silent_speech_tpu_torch.scripts.{script}")
        _kernels.reset_launch_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            reports[script] = mod.main([f"iters={RATE_ITERS}"])
        torch.cuda.synchronize()
        print("".join(f"  | {line}\n" for line in
                      out.getvalue().splitlines()[:-1]), end="")
        counts[script] = {k: v for k, v in _kernels.launch_counts().items()
                          if v}
        print(f"  {script}: launches over its full-size run {counts[script]}")
        want = {BWD_KIND_KERNEL[r["kind"]] for r in reports[script]["rows"]}
        if any(not counts[script].get(n) for n in want):
            fail(f"{script}: a kernel of its path was not launched: "
                 f"{counts[script]}, expected {sorted(want)}")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rates = {name: {"rows": {}} for name in BWD_KERNELS}
    for script, rep in reports.items():
        for r in rep["rows"]:
            share = r["bound_ms"] / r["ms"]
            r["share_of_bound"] = share
            tc = ""
            if "share_of_bar64" in r:
                tc = (f" (the same work: {r['library_ms_same_work']:.4f} ms); "
                      f"{r['share_of_bar64']:.3f} of the float64 bar,")
            print(f"  {script} {r['name']}: {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['rate']}), "
                  f"{share:.1%} of it; plain {r['plain_ms']:.4f} ms; library "
                  f"{r['library_ms']:.4f} ms{tc} "
                  f"{r['share_of_bar']:.3f} of the bar {card}")
            if share > 1.0:
                fail(f"{script} {r['name']}: {r['ms']:.4f} ms is {share:.1%} "
                     f"of its bound {r['bound_ms']:.4f} ms: it did less work "
                     "than the function")
            rates[BWD_KIND_KERNEL[r["kind"]]]["rows"][
                f"{script}:{r['name']}"] = {c: v for c, v in r.items()
                                            if c != "name"}
    for name, (_, (script, first)) in BWD_KERNELS.items():
        row = rates[name]["rows"][f"{script}:{first}"]
        rows = rates[name]["rows"].values()
        rates[name].update({k: row[k] for k in keys + (
            "route", "rate", "library_ms_same_work") if k in row})
        rates[name]["row"] = f"{script}:{first}"
        rates[name]["launches"] = sum(c.get(name, 0)
                                      for c in counts.values())
        for k in ("abs_err", "share_of_bar", "share_of_bar64"):
            key = "max_" + k if k == "abs_err" else k
            if key in row:
                rates[name]["rows_max_" + k] = max(r[key] for r in rows)
    dots2 = {r["name"]: r["ms"] for r in reports["proto_bwd_dots2"]["rows"]}
    rates["bwd_dot_xp"]["xp_over_tt"] = {}
    for m in (384, 1536):
        xp, tt = dots2[f"xp_m{m}"], dots2[f"tt_m{m}"]
        rates["bwd_dot_xp"]["xp_over_tt"][str(m)] = xp / tt
        print(f"  proto_bwd_dots2 m={m}: xp / tt {xp / tt:.4f} (xp - tt "
              f"{xp - tt:.4f} ms: the transposing stage) {card}")
    return counts, rates


def bwd_kernel_rows(bwd_ms: dict, bwd_errs: dict) -> list[dict]:
    """The kernels line's rows of the backward-dot kernels from
    run_bwd_dot_scripts' rates and check_bwd_dots' errors ("route" stays
    "cuda"; the products' route goes under "products")."""
    out = []
    for kname, (replaces, _) in BWD_KERNELS.items():
        r, e = bwd_ms[kname], bwd_errs[kname]
        row = {"name": kname, "route": "cuda",
               "source": "silent_speech_tpu_torch/csrc/bwd_dots.cu",
               "replaces": replaces, "launches": r["launches"],
               "max_abs_err": max(e["max_abs_err"], r["rows_max_abs_err"]),
               "share_of_bar": max(e["max_share_of_bar"],
                                   r["rows_max_share_of_bar"]),
               **{k: v for k, v in r.items() if not k.startswith("rows_max")
                  and k not in ("launches", "route")},
               "products": r["route"]}
        if "max_share_of_bar64" in e:
            row["share_of_bar64"] = max(e["max_share_of_bar64"],
                                        r["rows_max_share_of_bar64"])
            row["plan"] = e["plan"]
        out.append(row)
    return out


def time_bwd_stages(dev, card: str) -> dict:
    """bwd_dot_tt's mainloop by parts at dots1's (98,304 rows, m 384,
    K 512, N 256), each stop of ``cuda_bwd_dots.bwd_dot_tt_stop`` timed
    with the host's launches held out, beside torch.matmul (f32, TF32 off)
    at the same shape; ``all`` must be bitwise bwd_dot_tt. Returns
    {stop: ms, "library_ms": ...}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_bwd_dots as bd

    rng = np.random.default_rng(SEED + 13)
    with torch.no_grad(), full_f32():
        p = bd.draw(rng, (bd.ROWS, 512), dev)
        dy = bd.draw(rng, (bd.ROWS, 256), dev)
        if not torch.equal(bd.bwd_dot_tt_stop(p, dy, 384, "all"),
                           bd.bwd_dot_tt(p, dy, 384)):
            fail("bwd_dot_tt_stop 'all' is not bwd_dot_tt bitwise")
        out = {stop: held_ms(lambda: bd.bwd_dot_tt_stop(p, dy, 384, stop),
                             dev, RATE_ITERS) for stop in bd.STOPS}
        out["library_ms"] = held_ms(lambda: torch.matmul(p.T, dy), dev,
                                    RATE_ITERS)
    print(f"  bwd_dot_tt by parts, rows={bd.ROWS} m=384 K=512 N=256: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()) + f" {card}")
    return out


# ---- phase 12: the CTC family (slice 4) and the official trainer's options

# the CTC model's full width (CTCTrainConfig(): x_dim 180, hidden 192, 3
# layers, emb 32, 27 classes, max_t 80); serving and the sweep at B=64,
# the trainer's batch 32
B_CTC, B_CTC_TRAIN, T_CTC = 64, 32, 80
# train-ctc on the phase-5 corpus (10 words x 8 clips, 70 for training):
# at the default lr 1e-3 the model still emits mostly blanks after 30
# epochs (every clip decodes to the shortest word); 3e-3 for 60 epochs
CTC_EPOCHS, CTC_LR = 60, 3e-3
CTC_BIG_DICT = 1000  # the generated dictionary of the score_batch timings
BAR_CTC_LOGPROBS = 1e-3  # the serving bar of the official model's logits
# the JAX CTC trainer's checkpoint metadata (train/ctc_loop.py:188-196)
CTC_META = {"x_dim", "max_t", "vocab", "blank_id", "label_to_text",
            "uniq_labels", "exp_len", "len_lambda", "gru_layers", "seed",
            "roi_h", "roi_w"}


def ctc_words(n: int, seed: int) -> list[str]:
    """``n`` distinct random a-z words of 2..8 letters."""
    rng = np.random.default_rng(seed)
    words: set = set()
    while len(words) < n:
        k = int(rng.integers(2, 9))
        words.add("".join(chr(97 + int(c)) for c in rng.integers(0, 26, k)))
    return sorted(words)


def ctc_batch(B: int, rng, dev, words: list[str]):
    """B clips of T_CTC frames (lengths 20..80, the first 80) with uint8
    frames, and each clip's target: one of ``words``."""
    from silent_speech_tpu_torch.models import ctc_model

    X = torch.from_numpy(rng.standard_normal((B, T_CTC, 180))
                         .astype(np.float32)).to(dev)
    L = torch.from_numpy(rng.integers(T_CTC // 4, T_CTC + 1, B)).to(dev)
    L[0] = T_CTC
    R = torch.from_numpy(rng.integers(0, 256, (B, T_CTC, 48, 96),
                                      dtype=np.uint8)).to(dev)
    enc = [ctc_model.encode_text(words[int(i)])
           for i in rng.integers(0, len(words), B)]
    y = np.zeros((B, max(map(len, enc))), np.int64)
    for i, e in enumerate(enc):
        y[i, :len(e)] = e
    ylen = torch.tensor([len(e) for e in enc], device=dev)
    return X, L, R, torch.from_numpy(y).to(dev), ylen


def ctc_sweep_arrays(dec, files):
    """The clips as evaluate_ctc_dataset batches them: trimmed, padded to
    the decoder's max_t; and each clip's normalized label."""
    from silent_speech_tpu_torch.core.schema import load_clip
    from silent_speech_tpu_torch.infer.ctc_decode import trim_pad
    from silent_speech_tpu_torch.models.ctc_model import normalize_label

    clips = [load_clip(f).aligned() for f in files]
    Xs, Rs, Ls = zip(*(trim_pad(c.X, c.roi, dec.max_t, **dec.trim_kw)
                       for c in clips))
    return (np.stack(Xs), np.stack(Rs), np.asarray(Ls, np.int32),
            [normalize_label(c.label) for c in clips])


def run_cli(args: list[str]) -> str:
    """One CLI call, its standard output returned (and echoed); fails
    unless it exits 0."""
    from silent_speech_tpu_torch.apps import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    text = out.getvalue()
    print(text, end="")
    if rc != 0:
        fail(f"{' '.join(args[:2])} exited {rc}")
    return text


def breakdown_line(label: str, bd: dict, card: str) -> None:
    """One line of a :func:`device_breakdown`: wall, device busy, idle
    share and the categories by time."""
    if bd["busy_ms"] is None:
        print(f"  {label}: wall {bd['wall_ms']:.4f} ms; device time not "
              "measured (the profiler recorded no device events)")
        return
    cats = ", ".join(f"{k} {v:.4f}" for k, v in
                     sorted(bd["device_ms"].items(), key=lambda kv: -kv[1]))
    print(f"  {label}: wall {bd['wall_ms']:.4f} ms, device busy "
          f"{bd['busy_ms']:.4f} ms, idle share {bd['idle_share']:.4f}; "
          f"{cats}{' ' + card if card else ''}")


def check_ctc(p_cnn, flat, work: Path, labels: list[str], dev, card: str
              ) -> dict:
    """Phase 12, the CTC family at full width, random weights from SEED:

    - the CTC forward on K1 and K2 against the plain version (TF32 off) at
      B=64, T=80: log-probabilities within BAR_CTC_LOGPROBS and the
      10-word dictionary's argmax equal on every clip;
    - one CTC train step at B=32, T=80 (K3 at N=2,560, standardize off)
      against the plain step, at the official step parity's bars and
      near-tie rule (:func:`step_parity`, the loss bar relative);
    - the CLIs: train-ctc on the phase-5 corpus (meta contract, finite and
      falling loss, K1 and K3 every step, K1 and K2 every validation),
      eval-ctc over the 320 sweep clips in the f32, bf16, q8 and im2col
      modes (each mode's argmax equal to f32's on every clip), predict on
      one clip; the official train CLI with compute_dtype=bfloat16 and with
      host_data=true (its parameters bitwise the device-resident run's);
    - timings: the CTC train step (kernels and plain), score_batch clips/s
      at B=64 against 10 and 1,000 words, their device breakdowns and the
      lattice's, K1 at N=5,120, K2's three layers at B=64, T=80, K3 at
      N=2,560 with standardize off.

    Returns the kernels' CTC-path figures, {kernel name: dict}."""
    from silent_speech_tpu_torch.core.schema import load_clip
    from silent_speech_tpu_torch.data.corpus import scan_corpus
    from silent_speech_tpu_torch.infer.ctc_decode import (CTCDecoder,
                                                          Dictionary)
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.models import ctc_model
    from silent_speech_tpu_torch.models.bigru import tree_leaves
    from silent_speech_tpu_torch.ops import _kernels, cuda_cnn, cuda_gru
    from silent_speech_tpu_torch.ops import gru as gru_ops
    from silent_speech_tpu_torch.ops.ctc import (ctc_loss,
                                                 ctc_word_logprobs_clips)
    from silent_speech_tpu_torch.train.checkpoint import load_checkpoint
    from silent_speech_tpu_torch.train.ctc_loop import ctc_train_step
    from silent_speech_tpu_torch.train.step import make_optimizer

    rng = np.random.default_rng(SEED + 20)
    cfg = ctc_model.CTCConfig()
    params = ctc_model.init_params(cfg.x_dim,
                                   torch.Generator().manual_seed(SEED))
    model = ctc_model.BiGRUCTC.from_jax_params(params, cfg)
    words = Dictionary.from_words(labels)
    dec = CTCDecoder(model, words, device=dev)
    plain_dec = CTCDecoder(ctc_model.BiGRUCTC.from_jax_params(params, cfg),
                           words, device=dev, roi_impl="plain",
                           gru_impl="plain")
    out: dict = {"roi_cnn": {}, "gru_seq": {}, "gru_proj": {},
                 "roi_cnn_bwd": {}}

    # ---- the forward on K1 and K2 against the plain version
    X, L, R, _, _ = ctc_batch(B_CTC, rng, dev, labels)
    Xn, Ln, Rn = X.cpu().numpy(), L.cpu().numpy(), R.cpu().numpy()
    _kernels.reset_launch_counts()
    lp = dec.logprobs(Xn, Rn, Ln)
    torch.cuda.synchronize()
    fwd_counts = _kernels.launch_counts()
    print(f"  CTC forward B={B_CTC} T={T_CTC} (hidden 192, 3 layers, emb "
          f"32): launches {({k: v for k, v in fwd_counts.items() if v})}")
    if fwd_counts["roi_cnn"] != 1 or fwd_counts["gru_proj"] != 3 or \
            fwd_counts["gru_seq"] != 3:
        fail(f"the CTC forward did not run K1 once and K2 once a layer: "
             f"{fwd_counts}")
    ref = plain_dec.logprobs(Xn, Rn, Ln)
    err = check_close(f"CTC log-probs B={B_CTC} T={T_CTC} kernels vs plain",
                      lp, ref, BAR_CTC_LOGPROBS)
    s_k, s_p = dec.score_batch(Xn, Rn, Ln), plain_dec.score_batch(Xn, Rn, Ln)
    top2 = np.sort(s_p, -1)
    same = int((s_k.argmax(-1) == s_p.argmax(-1)).sum())
    print(f"  CTC dictionary ({len(labels)} words) argmax equal on "
          f"{same}/{B_CTC} clips (smallest top-2 margin "
          f"{(top2[:, -1] - top2[:, -2]).min():.4f}), scores max |d| "
          f"{np.abs(s_k - s_p).max():.3e}")
    if same != B_CTC:
        fail(f"CTC dictionary argmax equal on {same}/{B_CTC} clips")
    out["roi_cnn"]["ctc_max_abs_err_logprobs"] = err

    # ---- one train step, kernels vs plain (K3 at N=2,560, standardize off)
    cfg0 = ctc_model.CTCConfig(gru_dropout=0.0)
    params0 = ctc_model.init_params(cfg0.x_dim,
                                    torch.Generator().manual_seed(SEED + 1))
    Xt, Lt, Rt, yt, ylt = ctc_batch(B_CTC_TRAIN, rng, dev, labels)

    def loss_of(m, impl, train_cnn):
        lp_ = m(Xt, Lt, Rt, train=True, generator=torch.Generator(device=dev),
                roi_impl=impl, train_cnn=train_cnn)
        return ctc_loss(lp_, Lt, yt, ylt)

    step_parity(f"CTC train step B={B_CTC_TRAIN} T={T_CTC}",
                lambda: ctc_model.BiGRUCTC.from_jax_params(params0, cfg0),
                loss_of, 3e-4, 1e9, dev, loss_relative=True)

    # ---- the CLIs: train-ctc, eval-ctc in four modes, predict
    corpus = work / "train_clips"
    ckpt = str(work / "ctc.ckpt")
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    text = run_cli(["train-ctc", f"clip_dir={corpus}", f"out_path={ckpt}",
                    f"epochs={CTC_EPOCHS}", f"patience={CTC_EPOCHS}",
                    f"lr={CTC_LR}", f"batch_size={B_CTC_TRAIN}",
                    f"max_t={T_CTC}",
                    "device=cuda"])
    wall = time.perf_counter() - t0
    tr_counts = _kernels.launch_counts()
    losses = [float(v) for v in re.findall(
        r"^ep \d{3} \| loss (\S+) \| val acc \S+ \[", text, re.M)]
    accs = [float(v) for v in re.findall(
        r"^ep \d{3} \| loss \S+ \| val acc (\S+) \[", text, re.M)]
    n_files = len(scan_corpus(str(corpus), verbose=False).files)
    # the per-label split keeps max(1, int(8 * 0.15)) = 1 clip a word
    n_train = n_files - len(labels) * max(1, int(8 * 0.15))
    steps = len(losses) * -(-n_train // B_CTC_TRAIN)
    print(f"  train-ctc: {len(losses)} epochs, {n_train} training clips, "
          f"{steps} steps in {wall:.1f} s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, best val acc {max(accs):.3f}; launches "
          f"{({k: v for k, v in tr_counts.items() if v})} {card}")
    if not losses or not all(map(math.isfinite, losses)) or \
            not losses[-1] < losses[0]:
        fail(f"train-ctc losses {losses}: not finite and falling")
    if tr_counts["roi_cnn_bwd"] != steps or tr_counts["roi_cnn"] < steps or \
            tr_counts["gru_seq"] != 3 * len(losses):
        fail(f"train-ctc ({steps} steps, {len(losses)} validations) "
             f"launches {tr_counts}")
    _, meta, _ = load_checkpoint(ckpt)
    if set(meta) != CTC_META or meta["vocab"] != ctc_model.VOCAB or \
            meta["max_t"] != T_CTC or sorted(meta["uniq_labels"]) != \
            sorted(labels):
        fail(f"train-ctc checkpoint metadata {sorted(meta)}")
    out["roi_cnn_bwd"]["ctc_train_launches"] = tr_counts["roi_cnn_bwd"]
    out["roi_cnn"]["ctc_train_launches"] = tr_counts["roi_cnn"]

    sweep_dir = work / "sweep_clips"
    files = scan_corpus(str(sweep_dir), verbose=False).files
    sweep = {}
    mode_scores = {}
    for mode, (knobs, kname) in MODES.items():
        args = ["eval-ctc", f"ckpt_path={ckpt}", f"clip_dir={sweep_dir}",
                f"batch_size={B_CTC}", "device=cuda"] + \
            [f"{k}={v}" for k, v in knobs.items()]
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        text = run_cli(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _kernels.launch_counts()
        acc = float(re.search(r"^dataset acc: (\S+)", text, re.M).group(1))
        others = [k for _, k in MODES.values() if k != kname]
        if counts[kname] <= 0 or counts["gru_seq"] != 3 * counts[kname] or \
                any(counts[k] for k in others):
            fail(f"eval-ctc {mode}: launches {counts}")
        mdec = CTCDecoder.from_checkpoint(ckpt, device=dev, **knobs)
        if mode == "f32":
            Xs, Rs, Ls, true = ctc_sweep_arrays(mdec, files)
        mode_scores[mode] = np.concatenate([
            mdec.score_batch(Xs[i:i + B_CTC], Rs[i:i + B_CTC],
                             Ls[i:i + B_CTC])
            for i in range(0, len(files), B_CTC)])
        sweep[mode] = {"acc": acc, "clips_s": len(files) / wall,
                       "launches": counts[kname]}
        print(f"  eval-ctc {mode}: acc {acc:.4f}, {len(files) / wall:.1f} "
              f"clips/s ({wall:.3f} s, npz loading included), launches "
              f"{({k: v for k, v in counts.items() if v})} {card}")
    ref = mode_scores["f32"]
    pred = np.asarray(mdec.dict.words)[ref.argmax(-1)]
    acc = float(np.mean([p == t for p, t in zip(pred, true)]))
    if abs(acc - sweep["f32"]["acc"]) > 1e-12:
        fail(f"eval-ctc f32 accuracy {sweep['f32']['acc']} vs the decoder's "
             f"{acc}")
    if not acc >= 0.5:
        fail(f"the CTC checkpoint scores {acc} on the sweep: too little "
             "trained for an argmax gate to mean anything")
    top2 = np.sort(ref, -1)
    print(f"  dictionary argmax of each mode vs f32 over {len(files)} clips "
          f"(smallest top-2 margin in f32 "
          f"{(top2[:, -1] - top2[:, -2]).min():.4f}):")
    for mode in ("bf16", "q8", "im2col"):
        same = int((mode_scores[mode].argmax(-1) == ref.argmax(-1)).sum())
        drift = float(np.abs(mode_scores[mode] - ref).max())
        print(f"    {mode}: argmax equal on {same}/{len(files)} clips, max "
              f"|d score| {drift:.3e}")
        if same != len(files):
            fail(f"eval-ctc {mode}: argmax equal on {same}/{len(files)}")
    out["roi_cnn"]["ctc_eval_clips_s"] = sweep["f32"]["clips_s"]

    clip = files[0]
    text = run_cli(["predict", f"ckpt_path={ckpt}", f"clip={clip}",
                    "device=cuda", "k=3"])
    c = load_clip(clip).aligned()
    want = CTCDecoder.from_checkpoint(ckpt, device=dev, roi_impl="plain",
                                      gru_impl="plain").score_clip(c.X, c.roi)
    got = ast.literal_eval(text.strip()[len(clip) + 2:])
    if [w for w, _ in got] != [w for w, _ in want[:3]]:
        fail(f"predict on the CTC checkpoint: {got} vs plain {want[:3]}")

    # ---- the official trainer's options: bf16 and host_data
    for opts in (["compute_dtype=bfloat16"], ["host_data=true"], []):
        name = opts[0].split("=")[0] if opts else "device"
        path = str(work / f"opt_{name}.ckpt")
        _kernels.reset_launch_counts()
        text = run_cli(["train", f"clip_dir={corpus}", f"out_path={path}",
                        "epochs=3", f"lr={TRAIN_LR}",
                        f"batch_size={B_TRAIN}", "device=cuda"] + opts)
        counts = _kernels.launch_counts()
        lines = re.findall(r"^(ep \d\d \| train loss \S+ acc \S+ \| val "
                           r"loss \S+ acc \S+)", text, re.M)
        n_tr = int(re.search(r"^Train clips: (\d+)", text, re.M).group(1))
        steps = 3 * -(-n_tr // B_TRAIN)
        if len(lines) != 3 or counts["roi_cnn_bwd"] != steps:
            fail(f"train {' '.join(opts)}: {len(lines)} epochs, launches "
                 f"{counts}")
        sweep[name] = (lines, load_checkpoint(path)[0])
        print(f"  train {' '.join(opts) or '(device-resident corpus)'}: "
              f"{steps} steps, K3 launches {counts['roi_cnn_bwd']}")
    p16 = sweep["compute_dtype"][1]
    if not all(a.dtype == np.float32 and np.isfinite(a).all()
               for a in tree_leaves(p16)):
        fail("bf16 training: parameters not finite f32")
    (l_host, p_host), (l_dev, p_dev) = sweep["host_data"], sweep["device"]
    if l_host != l_dev or not all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(p_host), tree_leaves(p_dev))):
        fail("train host_data=true: not bitwise the device-resident run")
    print("  host_data=true: losses, accuracies and parameters bitwise the "
          "device-resident run's")

    # ---- timings
    print(f"CTC timings {card}:")
    tmodel = ctc_model.BiGRUCTC.from_jax_params(params, cfg).to(dev)

    def step_fn(impl):
        m = ctc_model.BiGRUCTC.from_jax_params(params, cfg).to(dev)
        opt = make_optimizer(m, 1e-3, grad_clip_norm=1e9)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return lambda: ctc_train_step(m, opt, Xt, Rt, Lt, yt, ylt, gen,
                                      roi_impl=impl)

    step_ms = {"kernel": cuda_ms(step_fn("auto"), 5, warmup=2)}
    with full_f32():
        step_ms["plain"] = cuda_ms(step_fn("plain"), 5, warmup=2)
    print(f"  CTC train step B={B_CTC_TRAIN} T={T_CTC} (feature noise, "
          f"dropout 0.1): kernels {step_ms['kernel']:.4f} ms, plain "
          f"{step_ms['plain']:.4f} ms (TF32 off) {card}")
    big = Dictionary.from_words(ctc_words(CTC_BIG_DICT, SEED + 22))
    sb = {}
    for name, d in (("10 words", words), ("1,000 words", big)):
        bdec = CTCDecoder(tmodel, d, device=dev)
        bdec.score_batch(Xn, Rn, Ln)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            bdec.score_batch(Xn, Rn, Ln)
        wall = (time.perf_counter() - t0) / 3
        cw = bdec.word_chunk(B_CTC)
        peak = torch.cuda.max_memory_allocated(dev) - base
        sb[name] = (bdec, B_CTC / wall)
        print(f"  score_batch B={B_CTC} T={T_CTC} against {name} (L_max "
              f"{d.ids.shape[1]}): {wall * 1e3:.3f} ms a call, "
              f"{B_CTC / wall:.1f} clips/s, {-(-len(d.words) // cw)} "
              f"lattice chunk(s) of {cw} words, peak memory over the "
              f"resident {peak / 2**20:.1f} MiB {card}")
    out["gru_seq"]["ctc_score_batch_clips_s"] = {k: v[1]
                                                 for k, v in sb.items()}
    print(f"CTC device breakdowns, ms per call, mean of 3 profiled calls "
          f"{card}:")
    breakdown_line(f"train step (kernels) B={B_CTC_TRAIN} T={T_CTC}",
                   device_breakdown(step_fn("auto")), card)
    for name, (bdec, _) in sb.items():
        breakdown_line(f"score_batch B={B_CTC} against {name}",
                       device_breakdown(lambda: bdec.score_batch(Xn, Rn, Ln)),
                       card)
        with torch.inference_mode():
            lpb = bdec.logprobs(Xn, Rn, Ln)
            ids, lens = bdec.dict.ids, bdec.dict.lens
            breakdown_line(f"  its lattice alone ({len(ids)} words)",
                           device_breakdown(lambda: ctc_word_logprobs_clips(
                               lpb, L, ids, lens)), card)

    # the kernels at the CTC path's shapes (the host's launches held out)
    N = B_CTC * T_CTC
    roi = R.reshape(N, 48, 96)
    ms = held_ms(lambda: cuda_cnn.roi_cnn_fused(roi, p_cnn, impl="kernel",
                                                flat=flat), dev)
    with full_f32():
        plain = cuda_ms(lambda: cuda_cnn.roi_cnn_plain(roi, p_cnn), 5)
    b_ms, b_by = k1_bound(N, CNN_FWD_MACS + 24 * 32,
                          N * (48 * 96 + 4 * 32) + 4 * flat.numel())
    share = check_bound(f"roi_cnn N={N} (CTC)", ms, b_ms)
    out["roi_cnn"].update(ctc_shape=f"N={N} (B={B_CTC} x T={T_CTC}), "
                          "standardize off", ctc_ms=ms, ctc_plain_ms=plain,
                          ctc_bound_ms=b_ms, ctc_bound_by=b_by,
                          ctc_serving_launches=fwd_counts["roi_cnn"])
    print(f"  roi_cnn N={N} (the CTC serving batch): kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {share:.1%} "
          f"of it {card}")
    # K2 over the three layers on the CTC input (the features and an
    # embedding; its values do not change the work)
    layers = tmodel.kernel_weights()["gru"]
    Z = torch.cat([X, torch.randn(B_CTC, T_CTC, cfg.roi_emb,
                                  generator=torch.Generator().manual_seed(
                                      SEED)).to(dev)], dim=-1)
    S = int(L.sum())
    with torch.no_grad():
        ms = held_ms(lambda: cuda_gru.bigru_kernel(Z, L, layers,
                                                   impl="kernel"), dev)
        with full_f32():
            plain = cuda_ms(lambda: gru_ops.bigru(Z, L, layers)[0], 3,
                            warmup=1)
    flops = nbytes = 0.0
    H = cfg.hidden
    for D in (cfg.x_dim + cfg.roi_emb,) + (2 * H,) * (cfg.gru_layers - 1):
        flops += 2 * 2 * S * (D + H) * 3 * H
        nbytes += 4 * (B_CTC * T_CTC * D + 2 * ((D + H) * 3 * H + 6 * H)
                       + B_CTC * T_CTC * 2 * H)
    b_ms, b_by = bound_ms(flops, nbytes)
    if ms < b_ms:
        fail(f"K2 over the CTC stack: {ms:.4f} ms under its bound {b_ms:.4f}")
    # the library's stack: torch.nn.GRU, 3 bidirectional layers with the
    # same weights, packed once, TF32 off (as K2's other library rows)
    with full_f32():
        held, events = gru_library_ms(layers, Z, L)
    out["gru_seq"].update(ctc_shape=f"3 bidirectional layers (D=212, 384, "
                          f"384; H=192), B={B_CTC} T={T_CTC}",
                          ctc_stack_ms=ms, ctc_stack_plain_ms=plain,
                          ctc_stack_bound_ms=b_ms, ctc_stack_bound_by=b_by,
                          ctc_stack_library_ms=min(held, events),
                          ctc_stack_library_held_ms=held,
                          ctc_stack_library_events_ms=events,
                          ctc_serving_launches=fwd_counts["gru_seq"])
    out["gru_proj"]["ctc_serving_launches"] = fwd_counts["gru_proj"]
    print(f"  K2 over the CTC stack (gru_proj + gru_seq a layer, 3 "
          f"layers) B={B_CTC} T={T_CTC}: {ms:.4f} ms, plain (the scan) "
          f"{plain:.4f} ms, torch.nn.GRU (cuDNN, 3 layers, packed once, "
          f"TF32 off) {min(held, events):.4f} ms (held {held:.4f}, events "
          f"{events:.4f}), bound {b_ms:.4f} ms ({b_by}) {card}")
    Nt = B_CTC_TRAIN * T_CTC
    rt = Rt.reshape(Nt, 48, 96)
    dE = torch.randn(Nt, 32, generator=torch.Generator().manual_seed(SEED)
                     ).to(dev)
    ms = held_ms(lambda: cuda_cnn.roi_cnn_weight_grads(
        rt, dE, flat, standardize=False), dev)
    plain = cuda_ms(lambda: plain_cnn_grads(rt, dE, p_cnn, False,
                                            torch.float32), 5)
    b_ms, b_by = k1_bound(Nt, CNN_FWD_MACS + CNN_BWD_MACS + 3 * 24 * 32,
                          Nt * (48 * 96 + 4 * 32) + 2 * 4 * flat.numel())
    share = check_bound(f"roi_cnn_bwd N={Nt} (CTC)", ms, b_ms)
    out["roi_cnn_bwd"].update(ctc_shape=f"N={Nt} (B={B_CTC_TRAIN} x "
                              f"T={T_CTC}), standardize off", ctc_ms=ms,
                              ctc_plain_ms=plain, ctc_bound_ms=b_ms,
                              ctc_bound_by=b_by, ctc_share_of_bound=share,
                              ctc_train_step_ms=step_ms["kernel"],
                              ctc_train_step_plain_ms=step_ms["plain"])
    print(f"  roi_cnn_bwd N={Nt} standardize=False (the CTC train step): "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), {share:.1%} of it {card}")
    return out


# ---- phase 13: the variant and legacy families (slice 5)
# the families at their reference widths, random weights from SEED: family
# -> (class, init arguments, the clips' feature width, the checkpoint's
# schema)
VARIANT_FAMILIES = {
    "reduced_d83": ("ReducedBiGRU", dict(d_in=83, num_classes=5), 83,
                    "word5"),
    "gru_word": ("GRUWordClassifier", dict(d_in=83, num_classes=20), 83,
                 "word5"),
    "unigru_d166": ("UniGRUClassifier", dict(d_in=166, num_classes=10), 83,
                    "1130pm"),
    "temporal_cnn": ("TemporalCNN", dict(d_in=180, num_classes=10), 180,
                     "dataset_eval"),
    "mlp": ("SummaryMLP", dict(in_dim=166, num_classes=5), 83, "quick"),
}
VARIANT_GRU = ("reduced_d83", "gru_word", "unigru_d166")
VARIANT_CLIP_T = (20, 45, 60, 75, 90)
# the legacy trainers on the card: command -> its overrides
LEGACY_RUNS = {"train-reduced": ["epochs=20", "batch_size=16"],
               "train-unigru": ["epochs=20", "batch_size=16"],
               "train-mlp": ["epochs=20", "batch_size=16"]}
# K2's bidirectional layer at the variant families' shapes: (H, D, T)
VARIANT_K2 = ((64, 83, 60), (128, 83, 40))
VARIANT_K2_B = (1, 64)


def variant_checkpoint(model, schema: str, d_clip: int, n: int,
                       path: str) -> None:
    """``model`` (``n`` classes, clips ``d_clip`` wide) saved in its
    reference ``.pt`` schema (the keys load_predictor routes on)."""
    sd = model.state_dict()
    words = [f"word{i}" for i in range(n)]
    if schema == "word5":
        ckpt = {"model": sd, "id_to_label": dict(enumerate(words)),
                "label_to_id": {w: i for i, w in enumerate(words)},
                "input_dim": d_clip, "max_t": 60, "words": words}
    elif schema == "1130pm":
        ckpt = {"model_state": sd, "d_in": 2 * d_clip,
                "id_to_word": dict(enumerate(words)), "t_target": 32,
                "d_target": d_clip, "use_deltas": True,
                "trim": {"q": 0.6, "margin": 2, "min_keep": 6}}
    elif schema == "dataset_eval":
        ckpt = {"model_state": sd, "d_in": d_clip, "num_classes": n,
                "id_to_word": dict(enumerate(words))}
    else:
        ckpt = {"model_state": sd, "labels": words, "in_dim": 2 * d_clip}
    torch.save(ckpt, path)


def time_variant_k2(dev, card: str) -> dict:
    """K2 on one bidirectional layer at the variant families' shapes
    (VARIANT_K2: the reduced model's H=64, T=60 and the GRU-word model's
    H=128, T=40, both at D=83, every clip at full length) at B=1 and 64:
    the layer, gru_proj and gru_seq with the host's launches held out
    (held_ms), torch.nn.GRU on the same inputs (packed once, TF32 off, the
    median of LIB_REPS readings: :func:`gru_library_median`), torch.addmm
    for gru_proj's product, the plain versions (CUDA events, TF32 off),
    the bounds from the shapes (the layer's and gru_proj's at the FMAs and
    3xTF32 together, gru_seq's at the f32 rate). Fails if a time is under
    its bound. Returns {"H=.. D=.. T=.. B=..": {key: value}}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_gru
    from silent_speech_tpu_torch.ops import gru as gru_ops
    from silent_speech_tpu_torch.ops.nn import gru_dir_init

    gen = torch.Generator().manual_seed(SEED + 13)
    out = {}
    for H, D, T in VARIANT_K2:
        pf, pb = ({k: v.to(dev) for k, v in gru_dir_init(D, H, gen).items()}
                  for _ in range(2))
        pack = cuda_gru.pack_layer([(pf, False), (pb, True)])
        layer = [{"fwd": pf, "bwd": pb, "packed": pack}]
        for B in VARIANT_K2_B:
            x = torch.randn(B, T, D, generator=gen).to(dev)
            L = torch.full((B,), T, dtype=torch.int32)
            Ld = L.to(dev)
            x2 = x.reshape(-1, D)
            pl = cuda_gru.plan(B, H, 2)
            pp = cuda_gru.proj_plan(B * T, D, 6 * H)
            xp = cuda_gru.gru_proj(x, pack.wi, pack.bi, impl="kernel",
                                   wt=pack.wt)
            r = {"C": pl.C, "BT": pl.BT, "blocks": pl.blocks,
                 "proj_route": pp.route, "proj_blocks": pp.blocks}
            r["layer_ms"] = held_ms(lambda: cuda_gru.bigru_kernel(
                x, Ld, layer, impl="kernel"), dev)
            r["proj_ms"] = held_ms(lambda: cuda_gru.gru_proj(
                x, pack.wi, pack.bi, impl="kernel", wt=pack.wt), dev)
            r["seq_ms"] = held_ms(lambda: cuda_gru.gru_recurrence(
                xp, Ld, pack, impl="kernel"), dev)
            with full_f32():
                med, lo, hi = gru_library_median(
                    [{"fwd": pf, "bwd": pb}], x, L)
                r["layer_library_ms"] = med
                r["layer_library_range_ms"] = [lo, hi]
                r["proj_library_ms"] = held_ms(lambda: torch.addmm(
                    pack.bi, x2, pack.wi), dev)
                r["layer_plain_ms"] = cuda_ms(lambda: gru_ops.bigru(
                    x, Ld, layer), 3, warmup=1)
                r["proj_plain_ms"] = cuda_ms(
                    lambda: cuda_gru.gru_proj_plain(x, pack.wi, pack.bi), 20)
                r["seq_plain_ms"] = cuda_ms(lambda: cuda_gru.gru_recurrence(
                    xp, Ld, pack, impl="plain"), 3, warmup=1)
            S = B * T
            r["layer_bound_ms"], r["layer_bound_by"] = tc_bound(
                2 * 2 * S * (D + H) * 3 * H,
                4 * (x.numel() + 2 * ((D + H) * 3 * H + 6 * H) + S * 2 * H))
            r["proj_bound_ms"], r["proj_bound_by"] = proj_bound(S, D, 6 * H)
            r["seq_bound_ms"], r["seq_bound_by"] = bound_ms(
                2 * 2 * S * H * 3 * H,
                4 * (S * 6 * H + 2 * (H * 3 * H + 3 * H) + S * 2 * H + B))
            print(f"  K2 bidirectional layer H={H} D={D} T={T} B={B} (C="
                  f"{pl.C}, BT={pl.BT}, {pl.blocks} blocks; gru_proj "
                  f"{pp.route} route, {pp.blocks} blocks): layer "
                  f"{r['layer_ms']:.4f} ms (gru_proj {r['proj_ms']:.4f} + "
                  f"gru_seq {r['seq_ms']:.4f}), torch.nn.GRU (packed once, "
                  f"TF32 off, median of {LIB_REPS}) {med:.4f} ms ({lo:.4f}-"
                  f"{hi:.4f}): x{med / r['layer_ms']:.2f}; plain "
                  f"{r['layer_plain_ms']:.4f} ms; bound "
                  f"{r['layer_bound_ms']:.4f} ms ({r['layer_bound_by']}) "
                  f"{card}")
            print(f"    gru_proj {r['proj_ms']:.4f} ms, torch.addmm "
                  f"{r['proj_library_ms']:.4f}, plain {r['proj_plain_ms']:.4f}"
                  f", bound {r['proj_bound_ms']:.4f} ({r['proj_bound_by']}); "
                  f"gru_seq {r['seq_ms']:.4f} ms, plain "
                  f"{r['seq_plain_ms']:.4f}, bound {r['seq_bound_ms']:.4f} "
                  f"({r['seq_bound_by']}) {card}")
            for key in ("layer_", "proj_", "seq_"):
                if r[key + "ms"] < r[key + "bound_ms"]:
                    fail(f"K2 {key[:-1]} H={H} B={B}: {r[key + 'ms']:.4f} "
                         f"ms is under its bound {r[key + 'bound_ms']:.4f}")
            out[f"H={H} D={D} T={T} B={B}"] = r
    return out


def check_variants(work: Path, dev, card: str) -> dict:
    """Phase 13, the variant and legacy families (slice 5) on the card:

    - each family of VARIANT_FAMILIES at its reference widths, random
      weights from SEED, saved in its reference ``.pt`` schema and loaded
      by ``load_predictor``; ``predict_features`` on clips of
      VARIANT_CLIP_T frames; the GRU families' launches of gru_proj and
      gru_seq over those calls (each must launch), their logits against
      the same checkpoint with gru_impl='plain' (within BAR_LOGITS, the
      same argmax) and their GRU outputs, kernel against plain, within
      BAR_GRU on each clip's input and on a batch of 64; the per-clip
      p50 of ``predict_features`` for each family;
    - the train-reduced, train-unigru and train-mlp CLIs on the card
      (LEGACY_RUNS) on a corpus of write_train_corpus (the five words
      train-reduced selects and two more, 8 clips each; the families
      ignore the ROI), K2's launches over each run (its validations);
      then eval-dataset and predict through the CLI on each checkpoint:
      the sweep's accuracy equal to an in-process
      ``evaluate_variant_dataset`` of the same checkpoint, predict's top
      word ``predict_features``';
    - K2's bidirectional layer at VARIANT_K2 beside torch.nn.GRU
      (:func:`time_variant_k2`).

    Returns {"launches": {kernel: count over the phase}, "errs": {...},
    "p50_ms": {...}, "k2": ...}."""
    from silent_speech_tpu_torch.core.schema import load_clip
    from silent_speech_tpu_torch.infer.evaluator import \
        evaluate_variant_dataset
    from silent_speech_tpu_torch.infer.predictor import (full_f32,
                                                         load_predictor)
    from silent_speech_tpu_torch.infer.variant_predictor import \
        VariantPredictor
    from silent_speech_tpu_torch.models import variants as V
    from silent_speech_tpu_torch.ops import _kernels
    from silent_speech_tpu_torch.train.legacy_loops import SELECTED_WORDS_5

    rng = np.random.default_rng(SEED + 13)
    launches = {"gru_proj": 0, "gru_seq": 0}
    errs = {"gru_out": 0.0, "logits": 0.0}
    p50 = {}
    vdir = work / "variants"
    vdir.mkdir()
    print(f"variant families, predict_features through load_predictor "
          f"(kernels vs gru_impl='plain', TF32 off) {card}:")
    for name, (cls, kw, d_clip, schema) in VARIANT_FAMILIES.items():
        model = getattr(V, cls).init(
            torch.Generator().manual_seed(SEED + len(name)), **kw)
        path = str(vdir / f"{name}.pt")
        variant_checkpoint(model, schema, d_clip, kw["num_classes"], path)
        pred = load_predictor(path, device="cuda")
        plain = load_predictor(path, device="cuda", gru_impl="plain")
        if not isinstance(pred, VariantPredictor) or \
                type(pred.model) is not getattr(V, cls):
            fail(f"{name}: load_predictor gave {type(pred).__name__}")
        clips = [rng.standard_normal((T, d_clip)).astype(np.float32)
                 for T in VARIANT_CLIP_T]
        pred.logits(clips[0])  # the packs and the first launches
        _kernels.reset_launch_counts()
        got = [pred.logits(X) for X in clips]
        counts = _kernels.launch_counts()
        launched = {k: v for k, v in counts.items() if v}
        gru = name in VARIANT_GRU
        layers = pred.model.gru.num_layers if gru else 0
        if gru and (counts["gru_proj"] != layers * len(clips)
                    or counts["gru_seq"] != layers * len(clips)):
            fail(f"{name}: launches {launched}, expected gru_proj and "
                 f"gru_seq {layers} a clip")
        if not gru and launched:
            fail(f"{name}: launches {launched}: the family has no kernel")
        for k in launches:
            launches[k] += counts[k]
        for X, g in zip(clips, got):
            want = plain.logits(X)
            errs["logits"] = max(errs["logits"], check_close(
                f"{name} logits T={len(X)}", torch.from_numpy(g),
                torch.from_numpy(want), BAR_LOGITS))
            if g.argmax() != want.argmax():
                fail(f"{name} T={len(X)}: argmax differs from the plain "
                     "route")
        if gru:
            xb = torch.from_numpy(np.stack([pred.preprocess(
                rng.standard_normal((int(t), d_clip)).astype(np.float32))
                for t in rng.integers(20, 91, 64)])).to(dev)
            x1 = torch.from_numpy(pred.preprocess(clips[-1])[None]).to(dev)
            with torch.inference_mode(), full_f32():
                for label, x in (("B=1", x1), ("B=64", xb)):
                    k = pred.model.run_gru(x, gru_impl="kernel")
                    p = pred.model.run_gru(x, gru_impl="plain")
                    errs["gru_out"] = max(errs["gru_out"], check_close(
                        f"{name} GRU outputs {label} {tuple(x.shape)}", k,
                        p, BAR_GRU))
        times = []
        for X in clips * 6:  # each call ends with its logits on the host
            t0 = time.perf_counter()
            pred.predict_features(X)
            times.append((time.perf_counter() - t0) * 1e3)
        p50[name] = statistics.median(times)
        print(f"  {name} ({cls}, {schema} schema): predict_features p50 "
              f"{p50[name]:.4f} ms a clip over {len(times)} clips of "
              f"{min(VARIANT_CLIP_T)}-{max(VARIANT_CLIP_T)} frames "
              f"(host clock); launches over the {len(clips)} checked "
              f"clips {launched} {card}")

    corpus = work / "variant_clips"
    write_train_corpus(corpus, SELECTED_WORDS_5 + ["yes", "no"], 8,
                       seed=SEED + 13)
    print(f"legacy trainers on the card ({corpus.name}: 7 words x 8 clips, "
          f"20-90 frames):")
    for cmd, over in LEGACY_RUNS.items():
        ckpt = str(work / f"{cmd}.ckpt")
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        text = run_cli([cmd, f"clip_dir={corpus}", f"out_path={ckpt}",
                        "device=cuda"] + over)
        wall = time.perf_counter() - t0
        counts = _kernels.launch_counts()
        launched = {k: v for k, v in counts.items() if v}
        print(f"  {cmd}: {wall:.1f} s, launches {launched} {card}")
        if not Path(ckpt).exists():
            fail(f"{cmd} wrote no checkpoint:\n{text}")
        if cmd != "train-mlp" and (counts["gru_seq"] <= 0
                                   or counts["gru_proj"] != counts["gru_seq"]):
            fail(f"{cmd}: its validations did not run K2: {launched}")
        for k in launches:
            launches[k] += counts[k]
        pred = load_predictor(ckpt, device="cuda")
        want = evaluate_variant_dataset(pred, str(corpus), verbose=False)
        _kernels.reset_launch_counts()
        text = run_cli(["eval-dataset", f"ckpt_path={ckpt}",
                        f"clip_dir={corpus}", "device=cuda"])
        counts = _kernels.launch_counts()
        acc = float(re.search(r"^dataset acc: (\S+)", text, re.M).group(1))
        if acc != want["accuracy"]:
            fail(f"{cmd}: eval-dataset acc {acc}, in-process "
                 f"evaluate_variant_dataset {want['accuracy']}")
        if cmd != "train-mlp" and counts["gru_seq"] != want["n"] * \
                pred.model.gru.num_layers:
            fail(f"{cmd}: eval-dataset launched gru_seq {counts['gru_seq']} "
                 f"times for {want['n']} clips")
        for k in launches:
            launches[k] += counts[k]
        clip = sorted(str(p) for p in corpus.glob("*.npz"))[0]
        line = run_cli(["predict", f"ckpt_path={ckpt}", f"clip={clip}",
                        "device=cuda", "k=2"]).strip()
        top = pred.predict_features(load_clip(clip).X.astype(np.float32),
                                    k=2)
        if ast.literal_eval(line[len(clip) + 2:])[0][0] != top[0][0]:
            fail(f"{cmd}: predict printed {line!r}, in-process {top}")
        print(f"  {cmd}: eval-dataset acc {acc:.4f} over {want['n']} clips "
              f"(in-process the same), predict {top[0][0]!r}")

    print(f"K2 at the variant families' shapes {card}:")
    k2 = time_variant_k2(dev, card)
    print(f"  phase 13 launches: {launches}")
    return {"launches": launches, "errs": errs, "p50_ms": p50, "k2": k2}


# ---- phase 14: the live camera path (slice 6a)
LIVE_SIM = 240  # frames of each command's sim run, 640x480 (the fake camera)
LIVE_B, LIVE_T = 64, 32  # the batched ops: 2,048 frames, 1.9 GB of uint8
# the batched crop against the host crop: a pixel whose f32 value lies
# within this of k + 0.5 may round apart (two sum orders), by one level
NEAR_ROUND = 1e-4
# the carry engine against the full scan over the same frames, and the
# batched features against the host frame path (tests/test_features.py)
BAR_CARRY, BAR_FEAT, REL_FEAT = 1e-5, 2e-4, 1e-4


def live_cli(args: list[str]) -> dict:
    """One camera command through the port's CLI in process, the fake
    camera's session included (``sim=``): its output, wall seconds, the
    kernels' launches over it, the logits of every ``predict_batch``, the
    host ms of every ``predict_arrays``, the rings it made, the logits
    each streaming engine handed to ``stream_probs``, the dictionary
    scores of every ``CTCDecoder.score_batch`` with its clips' lengths, and
    the per-frame log-probabilities of every ``CTCDecoder.logprobs`` (each
    clip's valid frames)."""
    from silent_speech_tpu_torch.apps import live
    from silent_speech_tpu_torch.infer import streaming
    from silent_speech_tpu_torch.infer.ctc_decode import CTCDecoder
    from silent_speech_tpu_torch.infer.predictor import Predictor
    from silent_speech_tpu_torch.ops import _kernels
    from silent_speech_tpu_torch.runtime import pipeline

    rec = {"logits": [], "ms": [], "rings": [], "stream": [], "scores": [],
           "lp": [], "audio": 0}
    saved = (Predictor.predict_batch, Predictor.predict_arrays,
             pipeline.FrameRing, streaming.stream_probs, live.play_audio,
             CTCDecoder.score_batch, CTCDecoder.logprobs)

    def batch(self, *a, **k):
        out = saved[0](self, *a, **k)
        rec["logits"].append(out.copy())
        return out

    def arrays(self, *a, **k):
        t0 = time.perf_counter()
        out = saved[1](self, *a, **k)
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def ring(*a, **k):
        rec["rings"].append(saved[2](*a, **k))
        return rec["rings"][-1]

    def probs(logits):
        rec["stream"].append(np.array(logits, np.float32))
        return saved[3](logits)

    def audio(path):  # the easter eggs' player: counted, no process
        rec["audio"] += 1

    def scores(self, X, roi, lengths):
        out = saved[5](self, X, roi, lengths)
        rec["scores"].append((np.array(out), np.array(lengths)))
        return out

    def logprobs(self, X, roi, lengths):
        out = saved[6](self, X, roi, lengths)
        rec["lp"].extend(out[b, :int(n)].float().cpu().numpy()
                         for b, n in enumerate(np.asarray(lengths)))
        return out

    Predictor.predict_batch, Predictor.predict_arrays = batch, arrays
    pipeline.FrameRing, streaming.stream_probs, live.play_audio = (
        ring, probs, audio)
    CTCDecoder.score_batch, CTCDecoder.logprobs = scores, logprobs
    try:
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rec["text"] = run_cli(args)
        torch.cuda.synchronize()
        rec["wall"] = time.perf_counter() - t0
        rec["counts"] = {k: v for k, v in _kernels.launch_counts().items()
                         if v}
    finally:
        (Predictor.predict_batch, Predictor.predict_arrays,
         pipeline.FrameRing, streaming.stream_probs, live.play_audio,
         CTCDecoder.score_batch, CTCDecoder.logprobs) = saved
    return rec


def live_pair(label: str, args: list[str], plain_args: list[str],
              kernels: tuple, card: str) -> dict:
    """A command on the kernels route and on the plain one: the kernels
    route must launch each of ``kernels`` and no other kernel, the plain
    route none; the same printed labels and argmaxes, logits (predict or
    stream) within BAR_LOGITS. Returns the kernels run's record."""
    got, want = live_cli(args), live_cli(args + plain_args)
    if sorted(got["counts"]) != sorted(kernels) or want["counts"]:
        fail(f"{label}: launches {got['counts']} (kernels route) and "
             f"{want['counts']} (plain route); expected {kernels} and none")
    for key in ("logits", "stream"):
        if len(got[key]) != len(want[key]):
            fail(f"{label}: {len(got[key])} {key} on the kernels route, "
                 f"{len(want[key])} on the plain one")
        if got[key]:
            g, w = np.concatenate(got[key]), np.concatenate(want[key])
            check_close(f"{label} {key} ({len(got[key])} calls) vs plain",
                        torch.from_numpy(g), torch.from_numpy(w), BAR_LOGITS)
            if not (g.argmax(-1) == w.argmax(-1)).all():
                fail(f"{label}: an argmax differs from the plain route")
    if len(got["lp"]) != len(want["lp"]) or any(
            g.shape != w.shape for g, w in zip(got["lp"], want["lp"])):
        fail(f"{label}: the CTC forwards' clips differ from the plain route")
    if got["lp"]:
        check_close(f"{label} CTC log-probs ({len(got['lp'])} clips, "
                    f"{sum(len(g) for g in got['lp'])} frames) vs plain",
                    torch.from_numpy(np.concatenate(got["lp"])),
                    torch.from_numpy(np.concatenate(want["lp"])), BAR_LOGITS)
    if len(got["scores"]) != len(want["scores"]):
        fail(f"{label}: {len(got['scores'])} dictionary sweeps on the "
             f"kernels route, {len(want['scores'])} on the plain one")
    for (g, n), (w, m) in zip(got["scores"], want["scores"]):
        # a word's score sums its lattice over the clip's frames: log-probs
        # within BAR_LOGITS a frame move it by at most BAR_LOGITS * T (the
        # length prior is the same on both routes)
        bar = BAR_LOGITS * n.astype(np.float64)[:, None]
        d = np.abs(g.astype(np.float64) - w)
        print(f"  {label}: dictionary sweep of {g.shape[1]} words, clips of "
              f"{n.tolist()} frames: max |d score| {d.max():.3e} (bar "
              f"{BAR_LOGITS:g} a frame, {bar.max():g})")
        if not (n == m).all() or not np.isfinite(g).all() or (d > bar).any():
            fail(f"{label}: dictionary scores off the plain route's beyond "
                 f"{BAR_LOGITS:g} a frame (lengths {n.tolist()} vs "
                 f"{m.tolist()})")
        if g.argmax(-1).tolist() != w.argmax(-1).tolist():
            fail(f"{label}: the dictionary argmax differs from the plain "
                 "route")
    lines = lambda r: re.findall(r"(?:Top3|Prediction): (\S+)", r["text"])
    if lines(got) != lines(want) or not (lines(got) or got["stream"]):
        fail(f"{label}: printed {lines(got)}, plain {lines(want)}")
    got["fps"] = LIVE_SIM / got["wall"]
    print(f"  {label}: {LIVE_SIM} sim frames in {got['wall']:.3f} s, "
          f"{got['fps']:.1f} frames/s (plain route "
          f"{LIVE_SIM / want['wall']:.1f}), "
          f"{len(got['logits'] + got['stream'] + got['scores'])} "
          "predictions, "
          f"launches {got['counts']} {card}")
    return got


def check_batched_ops(dev, card: str) -> dict:
    """The batched features and ROI crop on the card at LIVE_B x LIVE_T
    frames of 640x480x3 uint8 (random frames, fake faces of varied
    width, opening and place) against the host frame paths: the features
    at BAR_FEAT / REL_FEAT; the crop bitwise except on pixels within
    NEAR_ROUND of a rounding boundary, there by one level (their count
    printed). Times the batched crop (held-stream timer) and the host crop
    (a frame, host clock)."""
    from silent_speech_tpu_torch.ops import features as F
    from silent_speech_tpu_torch.ops import roi as R
    from silent_speech_tpu_torch.runtime.fakes import make_face

    rng = np.random.default_rng(SEED + 14)
    N = LIVE_B * LIVE_T
    faces = np.stack([make_face(
        float(rng.uniform(60, 150)), float(rng.uniform(2, 30)),
        center=(float(rng.uniform(0.3, 0.7)), float(rng.uniform(0.3, 0.7))),
        seed=i) for i in range(N)]).reshape(LIVE_B, LIVE_T, 468, 3)
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    frames = torch.randint(0, 256, (LIVE_B, LIVE_T, 480, 640, 3),
                           generator=g, device=dev, dtype=torch.uint8)
    feats, centers, mws = F.extract_features_batched(
        torch.from_numpy(faces).to(dev), 640, 480)
    host_feats, host_c, host_mw = [], [], []
    for b in range(LIVE_B):
        prev = None
        for t in range(LIVE_T):
            f, prev, c, mw = F.extract_features_frame(faces[b, t], 640, 480,
                                                      prev)
            host_feats.append(f)
            host_c.append(c)
            host_mw.append(mw)
    host_feats = np.stack(host_feats).reshape(LIVE_B, LIVE_T, -1)
    got = feats.cpu().numpy()
    err = float(np.abs(got - host_feats).max())
    if not np.allclose(got, host_feats, atol=BAR_FEAT, rtol=REL_FEAT):
        fail(f"batched features vs host: max |d| {err:.3e}")
    print(f"  batched features {tuple(got.shape)} vs the host frame path: "
          f"max |d| {err:.3e} (bars {BAR_FEAT:g} / rel {REL_FEAT:g})")
    host_c = np.asarray(host_c, np.float32).reshape(LIVE_B, LIVE_T, 2)
    host_mw = np.asarray(host_mw, np.float32).reshape(LIVE_B, LIVE_T)
    crop = lambda: R.crop_resize_gray_batched(
        frames, torch.from_numpy(host_c), torch.from_numpy(host_mw),
        input_layout="bgr")
    roi, ok = crop()
    vals = R.crop_resize_gray_values(frames, torch.from_numpy(host_c),
                                     torch.from_numpy(host_mw),
                                     input_layout="bgr")[0].cpu().numpy()
    roi, ok = roi.cpu().numpy(), ok.cpu().numpy()
    frames_h = frames.cpu().numpy()
    near = np.abs(vals - np.floor(vals) - 0.5) < NEAR_ROUND
    apart, host_ms = 0, []
    for b in range(LIVE_B):
        for t in range(LIVE_T):
            t0 = time.perf_counter()
            h = R.crop_resize_gray_frame_host(frames_h[b, t], host_c[b, t],
                                              float(host_mw[b, t]))
            host_ms.append((time.perf_counter() - t0) * 1e3)
            if h is None:
                if ok[b, t] or roi[b, t].any():
                    fail(f"crop ({b}, {t}): the host skips, batched ok")
                continue
            d = roi[b, t] != h
            if d.any() and (not near[b, t][d].all() or np.abs(
                    roi[b, t].astype(int) - h)[d].max() > 1):
                fail(f"batched crop ({b}, {t}) differs from the host crop "
                     "off a rounding boundary")
            apart += int(d.sum())
    del frames_h
    crop_ms = held_ms(crop, dev, iters=5)
    print(f"  batched crop {tuple(roi.shape)} vs the host crop: bitwise "
          f"but {apart} pixels, each within {NEAR_ROUND:g} of a rounding "
          f"boundary ({int(near.sum())} pixels lie there), by one level; "
          f"{int(ok.sum())}/{N} boxes ok")
    out = {"crop_ms": crop_ms, "host_crop_ms": statistics.median(host_ms),
           "crop_apart_px": apart, "crop_near_px": int(near.sum()),
           "feat_err": err}
    print(f"  batched crop: {crop_ms:.4f} ms for {N} frames (held-stream "
          f"timer, TF32 off) {card}")
    print(f"  host crop: {out['host_crop_ms']:.4f} ms a frame (p50 of {N}, "
          f"host clock) {card}")
    return out


def check_live(work: Path, dev, card: str) -> dict:
    """Phase 14, the live camera path (slice 6a), through the port's CLI in
    process with ``sim=LIVE_SIM`` (the fakes of runtime/fakes.py: 640x480
    frames, a face track with openness bursts, 'r' on frames 3 and
    LIVE_SIM - 8), each command on the kernels route and with
    roi_impl=plain gru_impl=plain (:func:`live_pair`):

    - ``infer-live`` and ``infer-gated`` (sequential and threaded) on the
      official model at full width (``BiGRUConfig()``, random weights from
      SEED): K1 and K2 launched, the same labels on every clip, logits
      within BAR_LOGITS; the threaded run through the native ring;
    - ``infer-stream engine=window`` on a GRU-word checkpoint at reference
      width (H=128, 2 layers, D=83): K2, against plain;
    - ``infer-stream engine=carry`` on a uni-GRU checkpoint (H=128,
      d_target 180, deltas): no kernel; its per-frame logits within
      BAR_CARRY of the full scan over the same frames;
    - ``infer-ctc`` at ``CTCTrainConfig()`` width (hidden 192, 3 layers,
      27 classes): K1 and K2; every clip's per-frame log-probs within
      BAR_LOGITS of plain, each word's score within BAR_LOGITS times the
      clip's frames, the same top word;
    - the batched features and crop (:func:`check_batched_ops`).

    Returns {"launches": {kernel: count over the kernels runs}, "p50_ms",
    "fps": {command: frames/s}, "ops": ...}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.infer.streaming import CarryStreamingGRU
    from silent_speech_tpu_torch.models import ctc_model
    from silent_speech_tpu_torch.models import variants as V
    from silent_speech_tpu_torch.models.bigru import BiGRUConfig, init_params
    from silent_speech_tpu_torch.ops import gru as gru_ops
    from silent_speech_tpu_torch.ops.nn import dense
    from silent_speech_tpu_torch.train.checkpoint import (load_checkpoint,
                                                          reference_meta,
                                                          save_checkpoint)

    t_phase = time.perf_counter()
    live_dir = work / "live"
    live_dir.mkdir(parents=True)
    gen = torch.Generator().manual_seed(SEED + 14)
    words = ["yes", "no", "hello", "thanks", "please", "fahhh", "six",
             "seven", "lebron", "aura"]
    i2l = dict(enumerate(words))
    cfg = BiGRUConfig()
    ckpt = {k: str(live_dir / f"{k}.ckpt") for k in ("official", "window",
                                                     "carry", "ctc")}
    save_checkpoint(ckpt["official"], init_params(cfg, gen), reference_meta(
        x_dim=cfg.x_dim, max_t=90, use_roi=True, roi_w=cfg.roi_w,
        roi_h=cfg.roi_h, labels=words,
        label_to_id={w: i for i, w in i2l.items()}, id_to_label=i2l,
        seed=SEED))
    save_checkpoint(ckpt["window"], V.GRUWordClassifier.init(
        gen, 83, 10, hidden=128, num_layers=2).params_tree(),
        {"input_dim": 83, "max_t": 90, "id_to_label": i2l})
    save_checkpoint(ckpt["carry"], V.UniGRUClassifier.init(
        gen, 360, 10, hidden=128).params_tree(),
        {"model": "unigru", "d_in": 360, "t_target": 32, "d_target": 180,
         "use_deltas": True, "id_to_word": i2l,
         "trim": {"margin": 2, "q": 0.6, "min_keep": 6}})
    save_checkpoint(ckpt["ctc"], ctc_model.init_params(
        180, gen, hidden=192, gru_layers=3, roi_emb=32),
        {"max_t": 80, "uniq_labels": words, "len_lambda": 0.02,
         "exp_len": 5})
    sim = [f"sim={LIVE_SIM}", "device=cuda"]
    plain = ["roi_impl=plain", "gru_impl=plain"]
    k12 = ("roi_cnn", "gru_proj", "gru_seq")
    runs = {}
    print(f"the live camera path, {LIVE_SIM} sim frames of 640x480 a "
          "command (kernels vs roi_impl=plain gru_impl=plain, TF32 off):")
    for label, args in (
            ("infer-live", ["infer-live"]),
            ("infer-gated", ["infer-gated"]),
            ("infer-gated threaded", ["infer-gated", "pipeline=threaded"])):
        runs[label] = live_pair(label, args + [
            f"ckpt_path={ckpt['official']}"] + sim, plain, k12, card)
    ring = runs["infer-gated threaded"]["rings"]
    if len(ring) != 1 or not ring[0].native or "pipeline: produced=" \
            f"{LIVE_SIM} consumed={LIVE_SIM}" not in \
            runs["infer-gated threaded"]["text"]:
        fail("the threaded gated run did not stream every frame through "
             "one native ring")
    if runs["infer-gated threaded"]["logits"] and [
            x.argmax() for x in runs["infer-gated threaded"]["logits"]] != [
            x.argmax() for x in runs["infer-gated"]["logits"]]:
        fail("infer-gated threaded predicted other clips than sequential")
    runs["infer-stream window"] = live_pair(
        "infer-stream window", ["infer-stream", f"ckpt_path={ckpt['window']}",
                                "engine=window"] + sim, ["gru_impl=plain"],
        ("gru_proj", "gru_seq"), card)
    runs["infer-ctc"] = live_pair(
        "infer-ctc", ["infer-ctc", f"ckpt_path={ckpt['ctc']}"] + sim, plain,
        k12, card)
    if not (runs["infer-ctc"]["scores"] and runs["infer-ctc"]["lp"]):
        fail("infer-ctc: no dictionary sweep to hold against plain")

    seen = []
    push = CarryStreamingGRU.push

    def spy(self, feat):
        out = push(self, feat)
        seen.append((np.array(feat, np.float32), out.copy()))
        return out

    CarryStreamingGRU.push = spy
    try:
        carry = live_cli(["infer-stream", f"ckpt_path={ckpt['carry']}",
                          "engine=carry"] + sim)
    finally:
        CarryStreamingGRU.push = push
    if carry["counts"] or len(seen) != LIVE_SIM or not carry["stream"]:
        fail(f"infer-stream carry: launches {carry['counts']}, {len(seen)} "
             f"steps for {LIVE_SIM} frames, {len(carry['stream'])} "
             "predictions")
    carry["fps"] = LIVE_SIM / carry["wall"]
    runs["infer-stream carry"] = carry
    tree = V.UniGRUClassifier.from_jax_params(
        load_checkpoint(ckpt["carry"])[0]).to(dev).params_tree()
    X = torch.from_numpy(np.stack([f for f, _ in seen])[None]).to(dev)
    with torch.inference_mode(), full_f32():
        top, _ = gru_ops.unidirectional_gru_chunked(
            X, torch.tensor([LIVE_SIM]), tree["gru"], chunk_size=LIVE_SIM)
        full = dense(top[0], tree["head"]).cpu()
    print(f"  infer-stream carry: {LIVE_SIM} sim frames in "
          f"{carry['wall']:.3f} s, {carry['fps']:.1f} frames/s, one GRU "
          f"step a frame (plain PyTorch, no kernel) {card}")
    check_close(f"infer-stream carry: per-frame logits ({LIVE_SIM} steps) "
                "vs the full scan over the same frames",
                torch.from_numpy(np.stack([lg for _, lg in seen])), full,
                BAR_CARRY)

    gated = runs["infer-gated"]["ms"]
    p50 = statistics.median(gated)
    print(f"  infer-gated: host p50 of one clip's prediction {p50:.4f} ms "
          f"(predict_arrays over {len(gated)} clips, host clock, kernels "
          f"route) {card}")
    print(f"batched live ops at B={LIVE_B}, T={LIVE_T} (640x480x3 uint8 "
          "frames on the card) against the host frame paths:")
    ops = check_batched_ops(dev, card)
    launches = {}
    for r in runs.values():
        for k, v in r["counts"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"  phase 14 launches: {launches}; phase 14 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "p50_ms": p50,
            "fps": {k: r["fps"] for k, r in runs.items()}, "ops": ops}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script runs only on a GPU")
    from silent_speech_tpu_torch.apps import cli
    from silent_speech_tpu_torch.infer.predictor import Predictor, full_f32
    from silent_speech_tpu_torch.models.bigru import (
        BiGRUConfig, init_params, init_roi_cnn)
    from silent_speech_tpu_torch.ops import _kernels, cuda_cnn, cuda_gru
    from silent_speech_tpu_torch.ops import gru as gru_ops
    from silent_speech_tpu_torch.ops.nn import gru_dir_init
    from silent_speech_tpu_torch.core.schema import load_clip
    from silent_speech_tpu_torch.data.corpus import scan_corpus
    from silent_speech_tpu_torch.train.checkpoint import (
        load_checkpoint, reference_meta, save_checkpoint)

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    card = f"[{smi}]"
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # ---- 2. build
    info = _kernels.build()
    print(f"build: {'compiled' if info.compiled else 'cached'} "
          f"{info.seconds:.1f} s -> {info.path.relative_to(ROOT)}")
    for line in info.log.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _kernels.library()

    # ---- 3. kernels vs plain on the card
    print("kernel vs plain (TF32 off for the plain version):")
    p_cnn = {k: {n: t.to(dev) for n, t in v.items()}
             for k, v in init_roi_cnn(32, gen).items()}
    flat = cuda_cnn.flat_weights(p_cnn)
    cnn_err = 0.0
    for N in (B_SERVE * T_SERVE, 1000):
        roi = torch.randint(0, 256, (N, 48, 96), generator=gen,
                            dtype=torch.uint8).to(dev)
        for std, bar in ((False, BAR_K1_LIVE), (True, BAR_K1_STD)):
            got = cuda_cnn.roi_cnn_fused(roi, p_cnn, standardize=std,
                                         impl="kernel", flat=flat)
            torch.cuda.synchronize()
            with full_f32():
                ref = cuda_cnn.roi_cnn_plain(roi, p_cnn, std)
            cnn_err = max(cnn_err, check_close(
                f"roi_cnn N={N} standardize={std}", got, ref, bar))

    lengths = torch.randint(5, T_SERVE + 1, (B_SERVE,), generator=gen)
    lengths[0] = T_SERVE
    gru_err = 0.0
    gru_p = {}
    for D in (212, 384):
        p = {k: v.to(dev) for k, v in gru_dir_init(D, 192, gen).items()}
        gru_p[D] = p
        x = torch.randn(B_SERVE, T_SERVE, D, generator=gen).to(dev)
        for reverse in (False, True):
            got = cuda_gru.gru_layer(x, lengths, p, reverse=reverse,
                                     impl="kernel")
            torch.cuda.synchronize()
            with full_f32():
                ref = gru_ops.gru_layer_single_direction(
                    x, lengths.to(dev), p, reverse=reverse)[0]
            gru_err = max(gru_err, check_close(
                f"gru_seq D={D} reverse={reverse}", got, ref, BAR_GRU))
    proj_err, seq_err = check_k2_parts(gru_p, lengths, dev)

    k3_abs, k3_rel = check_k3(p_cnn, flat,
                              torch.Generator().manual_seed(SEED + 3), dev)
    packs = mode_packs(p_cnn)
    mode_errs = check_serving_kernels(
        p_cnn, packs, torch.Generator().manual_seed(SEED + 4), dev)
    k1_errs = check_k1(p_cnn, flat, packs,
                       torch.Generator().manual_seed(SEED + 11), dev)

    # ---- 4. the serving path, full width, random weights from the seed
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    (work / "clips").mkdir(parents=True)
    cfg = BiGRUConfig()
    params = init_params(cfg, gen)
    labels = ["yes", "no", "hello", "thanks", "please", "six", "seven",
              "aura", "lebron", "fahhh"]
    l2i = {w: i for i, w in enumerate(labels)}
    meta = reference_meta(x_dim=cfg.x_dim, max_t=90, use_roi=True,
                          roi_w=cfg.roi_w, roi_h=cfg.roi_h, labels=labels,
                          label_to_id=l2i,
                          id_to_label={i: w for w, i in l2i.items()},
                          seed=SEED)
    ckpt = str(work / "model.ckpt")
    save_checkpoint(ckpt, params, meta)
    rng = np.random.default_rng(SEED)
    clips = {}
    for T in (5, 17, 32, 64, 90):  # one clip per bucket, in the clip format
        X = rng.standard_normal((T, cfg.x_dim)).astype(np.float32)
        roi = rng.integers(0, 256, (T, 48, 96), dtype=np.uint8)
        path = str(work / "clips" / f"smoke_yes_0_{T:04d}.npz")
        np.savez_compressed(path, X=X, ts=np.arange(T) * 33, label="yes",
                            speaker="smoke", roi=roi)
        clips[path] = (X, roi)
    Xb = rng.standard_normal((B_SERVE, T_SERVE, cfg.x_dim)).astype(np.float32)
    Lb = rng.integers(5, T_SERVE + 1, B_SERVE).astype(np.int32)
    Rb = rng.integers(0, 256, (B_SERVE, T_SERVE, 48, 96), dtype=np.uint8)

    print("serving path (kernels):")
    _kernels.reset_launch_counts()
    text = run_cli(["predict", f"ckpt_path={ckpt}",
                    f"clip={work / 'clips' / '*.npz'}", "device=cuda"])
    pred = Predictor.from_checkpoint(ckpt, device="cuda")
    logits = pred.predict_batch(Xb, Lb, Rb)
    counts = _kernels.launch_counts()
    print(f"  launches on the serving path: {counts}")
    if any(counts[k] <= 0 for k in ("roi_cnn", "gru_proj", "gru_seq")):
        fail(f"a kernel of the path was not launched: {counts}")

    cli_lines = text.strip().splitlines()
    plain = Predictor.from_checkpoint(ckpt, device="cuda", roi_impl="plain",
                                      gru_impl="plain")
    for line, (path, (X, roi)) in zip(cli_lines, sorted(clips.items())):
        want = plain.predict_arrays(X, roi)
        if not line.startswith(path) or \
                [w for w, _ in ast.literal_eval(line[len(path) + 2:])] != \
                [w for w, _ in want]:
            fail(f"predict CLI line {line!r} disagrees with the plain path "
                 f"{want}")
    if len(cli_lines) != len(clips):
        fail(f"predict CLI printed {len(cli_lines)} lines for {len(clips)} "
             "clips")
    ref = plain.predict_batch(Xb, Lb, Rb)
    check_close(f"predict_batch B={B_SERVE} T={T_SERVE} logits vs plain "
                "(card)", torch.from_numpy(logits), torch.from_numpy(ref),
                BAR_LOGITS)
    if not (logits.argmax(-1) == ref.argmax(-1)).all():
        fail("predict_batch argmax differs from the plain path")
    cpu = Predictor.from_checkpoint(ckpt, device="cpu")
    ref_cpu = cpu.predict_batch(Xb[:16], Lb[:16], Rb[:16])
    check_close("predict_batch B=16 logits vs plain (CPU)",
                torch.from_numpy(logits[:16]), torch.from_numpy(ref_cpu),
                BAR_LOGITS)
    if not (logits[:16].argmax(-1) == ref_cpu.argmax(-1)).all():
        fail("predict_batch argmax differs from the CPU reference")

    # ---- 5. the training path, full width, through the CLI
    print("training path (kernels):")
    corpus = work / "train_clips"
    write_train_corpus(corpus, labels, 8)
    n_clips = len(scan_corpus(str(corpus), verbose=False).files)
    tr_ckpt = str(work / "trained.ckpt")
    _kernels.reset_launch_counts()
    text = run_cli(["train", f"clip_dir={corpus}", f"out_path={tr_ckpt}",
                    f"epochs={TRAIN_EPOCHS}", f"lr={TRAIN_LR}",
                    f"batch_size={B_TRAIN}", "device=cuda"])
    train_counts = _kernels.launch_counts()
    for ep in range(1, TRAIN_EPOCHS + 1):
        m = re.search(rf"^ep {ep:02d} \| train loss (\S+) acc \S+ \| val "
                      rf"loss (\S+) acc ", text, re.M)
        if m is None or not all(math.isfinite(float(v)) for v in m.groups()):
            fail(f"train CLI printed no 'ep {ep:02d} |' line with finite "
                 "losses")
    n_train = int(re.search(r"^Train clips: (\d+)", text, re.M).group(1))
    steps = TRAIN_EPOCHS * -(-n_train // B_TRAIN)
    print(f"  {n_clips} clips, {n_train} for training: {steps} train steps; "
          f"launches over the train run: {train_counts}")
    if train_counts["roi_cnn_bwd"] != steps or train_counts["roi_cnn"] < steps:
        fail(f"the train run did not launch K1 and K3 every step ({steps} "
             f"steps): {train_counts}")
    tr_params, tr_meta, tr_opt = load_checkpoint(tr_ckpt)
    tr_plain = Predictor.from_checkpoint(tr_ckpt, device="cuda",
                                         roi_impl="plain", gru_impl="plain")
    n_leaves = sum(1 for _ in tr_plain.model.parameters())
    if tr_opt is None or len(tr_opt) != 1 + 2 * n_leaves:
        fail(f"the checkpoint holds no Adam state for {n_leaves} leaves")
    print(f"  checkpoint: epoch {tr_meta['epoch']}, best val acc "
          f"{tr_meta['best_val_acc']:.3f}, {len(tr_opt)} optimizer-state "
          "leaves")
    some = sorted(str(p) for p in corpus.glob("smoke_yes_0_000*.npz"))
    lines = run_cli(["predict", f"ckpt_path={tr_ckpt}",
                     f"clip={corpus / 'smoke_yes_0_000*.npz'}",
                     "device=cuda"]).strip().splitlines()
    if len(lines) != len(some) or not some:
        fail(f"predict CLI printed {len(lines)} lines for {len(some)} clips")
    for line, path in zip(lines, some):
        want = tr_plain.predict_clip(load_clip(path))
        if not line.startswith(path) or \
                ast.literal_eval(line[len(path) + 2:])[0][0] != want[0][0]:
            fail(f"predict on the trained checkpoint: {line!r} vs plain "
                 f"{want}")

    # ---- 5b. the serving modes: eval-dataset with the trained checkpoint
    sweep_dir = work / "sweep_clips"
    write_train_corpus(sweep_dir, labels, 32, seed=SEED + 5)
    sweep_files = scan_corpus(str(sweep_dir), verbose=False).files
    n_sweep = len(sweep_files)
    print(f"serving modes: the eval-dataset CLI over {n_sweep} clips, batch "
          f"{B_SWEEP}, checkpoint trained {TRAIN_EPOCHS} epochs {card}:")
    sweep = {}
    for mode, (knobs, kname) in MODES.items():
        args = ["eval-dataset", f"ckpt_path={tr_ckpt}",
                f"clip_dir={sweep_dir}", f"batch_size={B_SWEEP}",
                "device=cuda"] + [f"{k}={v}" for k, v in knobs.items()]
        _kernels.reset_launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mode_counts = _kernels.launch_counts()
        text = out.getvalue()
        if rc != 0:
            fail(f"eval-dataset {mode} exited {rc}:\n{text}")
        acc = float(re.search(r"^dataset acc: (\S+)", text, re.M).group(1))
        conf = float(re.search(r"^avg conf: (\S+)", text, re.M).group(1))
        launched = {k: v for k, v in mode_counts.items() if v}
        print(f"  {mode} ({' '.join(args[4:-1]) or 'defaults'}): acc "
              f"{acc:.4f}, avg conf {conf:.4f}, {n_sweep / wall:.1f} clips/s "
              f"({wall:.3f} s, npz loading included), launches {launched}")
        others = [k for _, k in MODES.values() if k != kname]
        if mode_counts[kname] <= 0 or mode_counts["gru_seq"] <= 0 or \
                mode_counts["gru_proj"] != mode_counts["gru_seq"] or \
                any(mode_counts[k] for k in others):
            fail(f"eval-dataset {mode}: launches {launched}, expected "
                 f"{kname}, gru_proj and gru_seq only")
        sweep[mode] = {"acc": acc, "conf": conf, "clips_s": n_sweep / wall,
                       "launches": mode_counts[kname]}
    if not sweep["f32"]["acc"] >= 0.5:
        fail(f"the checkpoint scores {sweep['f32']['acc']} on the sweep: "
             "too little trained for an argmax gate to mean anything")
    from silent_speech_tpu_torch.data.loader import load_corpus_arrays
    tr_cfg = tr_plain.cfg
    Xs_, Rs_, Ls_, _ = load_corpus_arrays(sweep_files, 90, tr_cfg.x_dim,
                                          True)
    mode_pred, mode_logits = {}, {}
    for mode, (knobs, _) in MODES.items():
        mode_pred[mode] = Predictor.from_checkpoint(tr_ckpt, device="cuda",
                                                    **knobs)
        mode_logits[mode] = np.concatenate([
            mode_pred[mode].predict_batch(Xs_[i:i + B_SWEEP],
                                          Ls_[i:i + B_SWEEP],
                                          Rs_[i:i + B_SWEEP])
            for i in range(0, n_sweep, B_SWEEP)])
    ref = mode_logits["f32"]
    top2 = np.sort(ref, -1)
    print(f"  logits vs the f32 kernels mode over the {n_sweep} clips "
          f"(smallest top-2 logit margin there {(top2[:, -1] - top2[:, -2]).min():.4f}):")
    for mode in ("bf16", "q8", "im2col"):
        drift = float(np.abs(mode_logits[mode] - ref).max())
        same = int((mode_logits[mode].argmax(-1) == ref.argmax(-1)).sum())
        sweep[mode]["drift"] = drift
        print(f"    {mode}: argmax equal on {same}/{n_sweep} clips, max "
              f"|d logit| {drift:.3e} (bar {LOGIT_TOL:g})")
        if same != n_sweep or not drift < LOGIT_TOL:
            fail(f"{mode}: argmax equal on {same}/{n_sweep} clips, drift "
                 f"{drift:.3e}")

    print("one train step, kernels vs plain (TF32 off, no dropout or "
          "augmentation):")
    cfg0 = BiGRUConfig(gru_dropout=0.0, head_dropout=0.0)
    params0 = init_params(cfg0, torch.Generator().manual_seed(SEED + 1))
    train_step_parity(params0, cfg0,
                      train_batch(cfg0, B_TRAIN, T_TRAIN, rng, dev), dev)

    # ---- 6. timings (CUDA events)
    print(f"timings {card}:")
    roi = torch.randint(0, 256, (B_SERVE * T_SERVE, 48, 96), generator=gen,
                        dtype=torch.uint8).to(dev)
    N = roi.shape[0]
    k1 = time_k1(p_cnn, flat, packs, roi, dev, card)
    dE = torch.randn(N, 32, generator=gen).to(dev)
    k3 = time_k3(p_cnn, flat, roi, dE, dev, card)
    mode_ms = time_modes(p_cnn, packs, roi, k1, dev, card)
    Xf, Lf, Rf = Xs_[:B_SWEEP], Ls_[:B_SWEEP], Rs_[:B_SWEEP]
    for mode, pr in mode_pred.items():
        ms = cuda_ms(lambda: pr.predict_batch(Xf, Lf, Rf), 10)
        print(f"  predict_batch {mode} B={B_SWEEP} T=90 (the sweep's "
              f"batches, host arrays in and out): {ms:.4f} ms, "
              f"{B_SWEEP / ms * 1e3:.1f} clips/s {card}")
    x = torch.randn(B_SERVE, T_SERVE, 212, generator=gen).to(dev)
    k2 = time_k2(gru_p[212], x, lengths, dev, card)
    k2p = time_k2p(gru_p, dev, card)
    for B in (B_SERVE, 1024):
        Xs = rng.standard_normal((B, T_SERVE, cfg.x_dim)).astype(np.float32)
        Ls = np.full((B,), T_SERVE, np.int32)
        Rs = rng.integers(0, 256, (B, T_SERVE, 48, 96), dtype=np.uint8)
        for name, p in (("kernels", pred), ("plain", plain)):
            ms = cuda_ms(lambda: p.predict_batch(Xs, Ls, Rs), 10)
            print(f"  predict_batch B={B} T={T_SERVE} {name}: {ms:.4f} ms, "
                  f"{B / ms * 1e3:.1f} clips/s {card}")
    X1, L1, R1 = Xs[:1], Ls[:1], Rs[:1]
    for name, p in (("kernels", pred), ("plain", plain)):
        for _ in range(5):
            p.predict_batch(X1, L1, R1)
        times = []
        for _ in range(50):
            times.append(cuda_ms(lambda: p.predict_batch(X1, L1, R1), 1, 0))
        print(f"  B=1 T={T_SERVE} forward {name}: p50 "
              f"{statistics.median(times):.4f} ms {card}")
    cfg_t = BiGRUConfig()
    params_t = init_params(cfg_t, torch.Generator().manual_seed(SEED + 2))
    step_ms = {}
    for B, T in ((B_TRAIN, T_TRAIN), (B_SERVE, T_SERVE)):
        batch = train_batch(cfg_t, B, T, rng, dev)
        for impl in ("kernel", "plain"):
            fn = train_step_fn(params_t, cfg_t, batch, dev, impl)
            ctx = full_f32() if impl == "plain" else contextlib.nullcontext()
            with ctx:
                step_ms[B, T, impl] = cuda_ms(fn, 5, warmup=2)
        print(f"  train step B={B} T={T} (official augmentation and "
              f"dropout): kernels {step_ms[B, T, 'kernel']:.4f} ms, plain "
              f"{step_ms[B, T, 'plain']:.4f} ms (TF32 off) {card}")

    # ---- 7. where the time goes (torch.profiler), kernels path
    print(f"device breakdown, predict_batch T={T_SERVE}, ms per call, mean "
          f"of 3 profiled calls {card}:")
    for B in (1, B_SERVE, 1024):
        Xs = rng.standard_normal((B, T_SERVE, cfg.x_dim)).astype(np.float32)
        Ls = np.full((B,), T_SERVE, np.int32)
        Rs = rng.integers(0, 256, (B, T_SERVE, 48, 96), dtype=np.uint8)
        breakdown_line(f"B={B}", device_breakdown(
            lambda: pred.predict_batch(Xs, Ls, Rs)), "")

    print(f"device breakdown, predict_batch per serving mode, B={B_SWEEP} "
          f"T=90 (the sweep's batches), ms per call {card}:")
    for mode, pr in mode_pred.items():
        breakdown_line(mode, device_breakdown(
            lambda: pr.predict_batch(Xf, Lf, Rf)), "")

    print(f"device breakdown, train step (kernels) B={B_SERVE} "
          f"T={T_SERVE}, ms per step, mean of 3 profiled steps {card}:")
    breakdown_line("train step", device_breakdown(train_step_fn(
        params_t, cfg_t, train_batch(cfg_t, B_SERVE, T_SERVE, rng, dev), dev,
        "kernel")), "")

    # ---- 8. the GRU probes: kernels vs plain, timings, the four scripts
    print("GRU probes, kernel vs plain (TF32 off):")
    probe_errs = check_gru_probes(torch.Generator().manual_seed(SEED + 6),
                                  dev)
    print(f"GRU probes, timings {card}:")
    probe_ms = time_gru_probes(dev, card)
    print(f"GRU probes, the scripts at B=512 and B=1, T={PROBE_T}, "
          f"{PROBE_ITERS} timed calls a variant {card}:")
    probe_counts = run_gru_probe_scripts()

    # ---- 9. the CNN-front prototypes: kernels vs plain, timings, scripts
    print("CNN-front prototypes, kernel vs plain (TF32 off):")
    front_errs = check_cnn_front(dev)
    print(f"CNN-front prototypes, timings at N={FRONT_N} {card}:")
    front_ms = time_cnn_front(dev, card)
    print(f"CNN-front prototypes, the scripts at N={FRONT_N}, {FRONT_ITERS} "
          f"timed calls a row {card}:")
    front_counts = run_cnn_front_scripts()

    # ---- 10. the forward rate probes: kernels vs plain, timings, scripts
    print("forward rate probes, kernel vs plain (TF32 off):")
    rate_errs = check_rate_probes(dev)
    print(f"forward rate probes, the scripts at full size, {RATE_ITERS} timed "
          f"calls a row {card}:")
    rate_counts, rate_ms = run_rate_probe_scripts(card)
    print(f"the bf16 chain's variants, {RATE_ITERS} timed calls each {card}:")
    rate_ms["dot_chain"]["bf16_variants"] = time_dc_variants(dev, card)
    print(f"MR's and DC-f32's parts {card}:")
    rate_ms["mm_rate"]["parts"] = time_mr_dc_f32(dev, card)
    print(f"LP's moving bodies beside their library calls, cold L2 {card}:")
    rate_ms["layout_micro"]["moves"] = time_lp_moves(dev, card)

    # ---- 11. the backward-dot probes: kernels vs plain, the scripts
    print("backward-dot probes, kernel vs plain (TF32 off):")
    bwd_errs = check_bwd_dots(dev)
    print("nt at dots1's shapes: its controls and 3-pass stop:")
    bwd_errs["bwd_dot_nt"].update(check_nt(dev))
    print(f"backward-dot probes, the scripts at full size, {RATE_ITERS} timed "
          f"calls a row {card}:")
    _, bwd_ms = run_bwd_dot_scripts(card)
    bwd_ms["bwd_dot_tt"]["stages_ms"] = time_bwd_stages(dev, card)
    print(f"nt in three TF32 passes and one, {RATE_ITERS} timed calls each "
          f"{card}:")
    bwd_ms["bwd_dot_nt"]["variants_ms"] = time_nt_variants(dev, card)

    # ---- 12. the CTC family, and the official trainer's bf16 and
    # host_data options
    print("the CTC family, full width (kernels vs plain with TF32 off, the "
          "CLIs, the trainer's options):")
    ctc = check_ctc(p_cnn, flat, work, labels, dev, card)

    # ---- 13. the variant and legacy families (slice 5)
    print("the variant and legacy families (kernels vs plain with TF32 off, "
          "the CLIs):")
    variants = check_variants(work, dev, card)

    # ---- 14. the live camera path (slice 6a)
    live = check_live(work, dev, card)

    def k1_row(kname, launches, err):
        by_n = {str(Nk): r for (name, Nk), r in k1.items() if name == kname}
        return {"name": kname, "route": "cuda",
                "source": "silent_speech_tpu_torch/csrc/roi_cnn.cu",
                "replaces": "silent_speech_tpu/ops/pallas_cnn2.py:1018",
                "launches": launches, "max_abs_err": err,
                **by_n[str(N)], "library_ms": None,
                **{k + "_sweep_shape": by_n[str(B_SWEEP * 90)][k]
                   for k in ("ms", "plain_ms", "bound_ms")},
                "by_frames": by_n}

    result = {"kernels": [
        k1_row("roi_cnn", counts["roi_cnn"], max(cnn_err, k1_errs["roi_cnn"])),
        k1_row("roi_cnn_bf16", sweep["bf16"]["launches"],
               max(mode_errs["roi_cnn_bf16"], k1_errs["roi_cnn_bf16"])),
        {"name": "gru_seq", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/gru_seq.cu",
         "replaces": "silent_speech_tpu/ops/pallas_gru.py:165",
         "launches": counts["gru_seq"],
         "max_abs_err": max(gru_err, seq_err),
         "ms": k2[B_SERVE]["seq_ms"],
         "plain_ms": k2[B_SERVE]["seq_plain_ms"],
         "bound_ms": k2[B_SERVE]["seq_bound_ms"],
         "bound_by": k2[B_SERVE]["seq_bound_by"],
         "library_ms": None,
         "layer_of": f"one bidirectional layer (gru_proj + gru_seq), "
                     f"B={B_SERVE} T={T_SERVE} D=212; layer_library_ms: "
                     f"torch.nn.GRU",
         **{k: v for k, v in k2[B_SERVE].items()
            if not k.startswith(("proj_", "seq_"))},
         "by_batch": {str(B): {k: v for k, v in r.items()
                               if not k.startswith("proj_")}
                      for B, r in k2.items()}},
        {"name": "gru_proj", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/gru_proj.cu",
         "replaces": "silent_speech_tpu/ops/pallas_gru.py:165 (the "
                     "projection in its body, :95-99)",
         "launches": counts["gru_proj"], "max_abs_err": proj_err,
         "ms": k2[B_SERVE]["proj_ms"],
         "plain_ms": k2[B_SERVE]["proj_plain_ms"],
         "bound_ms": k2[B_SERVE]["proj_bound_ms"],
         "bound_by": k2[B_SERVE]["proj_bound_by"],
         "library_ms": k2[B_SERVE]["proj_library_ms"],
         "by_batch": {str(B): {k: r[k] for k in (
             "proj_ms", "proj_plain_ms", "proj_library_ms", "proj_bound_ms")}
             for B, r in k2.items()},
         "by_shape": k2p},
        {"name": "roi_cnn_bwd", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/roi_cnn_bwd.cu",
         "replaces": "silent_speech_tpu/ops/pallas_cnn2_grad.py:319",
         "launches": train_counts["roi_cnn_bwd"], "max_abs_err": k3_abs,
         "max_rel_err": k3_rel, **k3[N], "library_ms": None,
         **{k + "_protocol_step": k3[K3_STEP_N][k]
            for k in ("ms", "plain_ms", "bound_ms", "share_of_bound")},
         "plan": cuda_cnn.bwd_plan()._asdict()},
    ]}
    result["kernels"][1]["eval_dataset_clips_s"] = sweep["bf16"]["clips_s"]
    from silent_speech_tpu_torch.ops import cuda_cnn_im2col, cuda_cnn_q8
    for kname, mode, replaces, plan in (
            ("roi_cnn_q8", "q8", "silent_speech_tpu/ops/pallas_cnn2.py:937",
             cuda_cnn_q8.plan),
            ("roi_cnn_im2col", "im2col",
             "silent_speech_tpu/ops/pallas_cnn.py:328", cuda_cnn_im2col.plan)):
        sw = mode_ms[kname, B_SWEEP * 90]
        result["kernels"].append({
            "name": kname, "route": "cuda",
            "source": f"silent_speech_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces, "launches": sweep[mode]["launches"],
            "max_abs_err": mode_errs[kname], **mode_ms[kname, N],
            "library_ms": None,
            **{k + "_sweep_shape": sw[k] for k in sw},
            "plan": plan()._asdict(),
            "eval_dataset_clips_s": sweep[mode]["clips_s"]})
    for kname, (source, replaces, script, count) in PROBE_KERNELS.items():
        result["kernels"].append({
            "name": kname, "route": "cuda",
            "source": f"silent_speech_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": probe_counts[script][count],
            "max_abs_err": probe_errs[kname], **probe_ms[kname]})
    for kname, (source, replaces, script) in FRONT_KERNELS.items():
        result["kernels"].append({
            "name": kname, "route": "cuda",
            "source": f"silent_speech_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": front_counts[script][kname],
            **front_errs[kname], **front_ms[kname]})
    for kname, (source, replaces, script, _) in RATE_KERNELS.items():
        result["kernels"].append({
            "name": kname, "route": "cuda",
            "source": f"silent_speech_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": rate_counts[script][kname],
            **rate_errs[kname], **rate_ms[kname]})
    result["kernels"] += bwd_kernel_rows(bwd_ms, bwd_errs)
    for row in result["kernels"]:
        if row["name"] in ctc:
            row["ctc_path"] = ctc[row["name"]]
        if row["name"] in variants["launches"]:
            part = "seq_" if row["name"] == "gru_seq" else "proj_"
            row["variant_path"] = {
                "launches": variants["launches"][row["name"]],
                "max_abs_err_gru_outputs": variants["errs"]["gru_out"],
                "max_abs_err_logits": variants["errs"]["logits"],
                "by_shape": {shape: {k: v for k, v in r.items()
                                     if k.startswith((part, "layer_"))}
                             for shape, r in variants["k2"].items()}}
        if row["name"] in ("roi_cnn", "gru_proj", "gru_seq"):
            row["live_path"] = {
                "launches": live["launches"].get(row["name"], 0),
                "gated_clip_p50_ms": live["p50_ms"],
                "sim_frames_s": live["fps"]}
    print(json.dumps(result))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k2-parent"]:  # K2 against a parent's checkout
        k2_against_parent(Path(sys.argv[2]).resolve(), "")
        sys.exit(0)
    sys.exit(main())
