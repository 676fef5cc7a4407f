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
   twice on the same inputs (bitwise-equal); the serving modes' ROI CNN
   kernels (K1-bf16, K4 int8, K5 im2col) at N=8192, a ragged N=33, N=1 and
   on all-0 and all-255 frames, and K4 on sub-batches (bitwise-equal rows);
4. the serving path at full width (random weights from a seed): the
   ``predict`` CLI on clips of 5..90 frames, and ``Predictor.predict_batch``
   at B=256, T=32 against the plain path on the card and on the CPU, with
   the kernels' launch counts over that run;
5. the training path at full width: the ``train`` CLI for 10 epochs at
   batch 16, lr 1e-3, on a synthetic corpus (10 words x 8 clips of 20..90
   frames), with the kernels' launch counts over that run, then ``predict``
   on its checkpoint; and one train step (B=16, T=90, no dropout or
   augmentation) through the kernels against the plain path;
5b. the serving modes: the ``eval-dataset`` CLI with that checkpoint over a
   second synthetic corpus (10 words x 32 clips of 20..90 frames, batch 64)
   in four modes: f32 kernels, bf16, int8 (tiled3_q8) and im2col, with
   each run's launch counts, accuracy, average confidence and clips/s; each
   mode's logits on the whole corpus against the f32 kernels mode (argmax
   equal for every clip, drift under tests/test_bf16_parity.py's 0.15);
6. timings with CUDA events: each kernel, its plain version and, where one
   exists, the PyTorch library call for the same function; each kernel's
   bound; the serving modes' kernels at the sweep's shape (64 x 90 = 5,760
   frames) and at N=8192, and their forward at B=64, T=90; serving clips/s
   at B=256 and B=1024 (T=32), p50 latency at B=1; train steps at B=16,
   T=90 and B=256, T=32;
7. a torch.profiler pass over ``predict_batch`` at B=1, 256 and 1024
   (T=32), over each serving mode at B=64, T=90, and over the B=256 train
   step: device time by kernel and copy, and the device's idle share;
8. the GRU probes (silent_speech_tpu_torch/scripts): the recurrence kernel
   with one and two weight sets, K2's one-direction launch and the
   dual-chain kernel against their plain versions at B=1, 33 and 512, T=32,
   D=180 and 384, f32 and bf16_mm; their times, bounds and cuDNN's layer
   at B=512 and B=1; and the main() of bench_gru, proto_gru2, proto_gru3
   and proto_gru4 at B=512 and B=1 (5 timed calls a variant), with the
   launch counts over each script's runs;
9. the CNN-front prototypes (silent_speech_tpu_torch/scripts): the parity
   conv1 + pool1 kernel in both layouts against its plain version at
   N=8192 and N=16, on all-0 and all-255 frames, with packed and random
   weights, its ablation's ``full`` bitwise the kernel; each stage of the
   front probe and each of K1's debug stops against its plain version; K1
   itself within its bar; their times, bounds and plain versions' times at
   N=8192; and the main() of proto_parity_cnn, proto_parity_e2e,
   proto_ablate and probe_front at N=8192, with the launch counts over each;
10. the forward rate probes (silent_speech_tpu_torch/scripts): the
   matmul-rate kernel (MR) at bench_fused_cnn's six shapes and small ragged
   ones, the chained-dot kernel (DC) in its four modes at K=384 and 512,
   and the layout kernel (LP) in its nine bodies, each against its plain
   version (DC in bf16 also product by product, with two controls that
   must fail); then the main() of probe_int8, bench_fused_cnn (mxu, main
   and ftile) and mosaic_micro at full size, with the launch counts over
   each, whose rows give the kernels' times, bounds (a row above 100% of
   its bound fails), and the plain versions' and library calls' times;
11. the backward-dot probes (silent_speech_tpu_torch/scripts): the tt, xp,
   nt, base and nn kernels against their plain versions at small ragged
   shapes (rows 100, m 24, K 104, N 130; dots3's form at 7 steps), tt and
   base twice on the same full-size inputs (bitwise equal), nt's tail rows
   exact zeros; then the main() of proto_bwd_dots, proto_bwd_dots2 and
   proto_bwd_dots3 at full size, with the launch counts over each, whose
   rows hold each kernel against its plain version at the scripts' shapes
   and give its time, bound (a row above 100% of it fails), and the plain
   version's and the library call's times.

Then one JSON line with the kernels' results, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Needs one CUDA device;
refuses to run without one. Scratch files go under build/chip_smoke/ in the
checkout.
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
# K3: max |d| / max |ref| per gradient tensor (tests/test_fused_train.py);
# train step: loss, gradients and post-Adam parameters
# (tests/test_fused_train.py:180-189, tests/test_train.py:94-113)
BAR_K3, BAR_LOSS, BAR_GRAD, BAR_PARAM = 5e-5, 1e-5, 1e-4, 3e-4
# K3 at N=1000 and 8192: two f32 implementations route some near-tied 2x2
# pool windows to different inputs; the f32 plain version itself lies up to
# 2.4e-4 from its float64 evaluation there (PERF.md, section 6)
BAR_K3_ROUTING = 5e-4
# the serving modes' ROI CNN kernels against their plain versions: bf16
# differs where an f32 sum, taken in another order, crosses a bf16 rounding
# boundary (one bf16 step of one activation, about 1e-6 of the output); on
# a constant frame every interior position computes the same sum, so one
# crossing moves a whole map by one bf16 step (2^-8 of it: up to about 1e-3
# of the output), hence the second bar, for constant frames only; int8 is
# bitwise its plain version up to the last ReLU, so only the mean and the
# fc reassociate (a requantization level moved by one f32 bit would show as
# about 1e-4); im2col computes K1's function (K1's bars)
BAR_BF16, BAR_BF16_CONST, BAR_Q8 = 1e-4, 2e-3, 1e-6
LOGIT_TOL = 0.15  # the serving modes vs f32 (tests/test_bf16_parity.py)
B_SERVE, T_SERVE = 256, 32
B_TRAIN, T_TRAIN = 16, 90  # the reference protocol (core/config.py)
TRAIN_EPOCHS, TRAIN_LR = 10, 1e-3
B_SWEEP = 64  # eval-dataset's batch; clips pad to the checkpoint's max_t 90
# the serving modes: Predictor knobs and the ROI CNN kernel each runs
MODES = {"f32": ({}, "roi_cnn"),
         "bf16": ({"compute_dtype": "bfloat16"}, "roi_cnn_bf16"),
         "q8": ({"roi_variant": "tiled3_q8"}, "roi_cnn_q8"),
         "im2col": ({"roi_variant": "im2col"}, "roi_cnn_im2col")}
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): f32 on
# the CUDA cores, bf16 and int8 on the tensor cores, and HBM bandwidth
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
PEAK_BF16_FLOPS, PEAK_INT8_OPS = 989e12, 1979e12
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
# the recurrence kernel's (batch_tile, k_steps): the defaults in f32; with
# bf16_mm it keeps Wh (221,184 bytes at H=192) in shared memory, beside
# which a 2-row, 1-step stage fits
REC_KNOBS = {False: {}, True: {"batch_tile": 2, "k_steps": 1}}
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
# multiply-adds a frame up to each of K1's debug stops (conv0, conv1, conv2)
STOP_MACS = {"load": 0, "norm": 0, "conv1": 48 * 96 * 8 * 9,
             "conv2": 48 * 96 * 8 * 9 + 24 * 48 * 16 * 8 * 9,
             "conv3": CNN_FWD_MACS}

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
# ragged against the 64 x 64 tile; DC at 3 steps; LP at 2 steps
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
        elif "gru_seq_kernel" in name:
            cat = "K2 gru_seq"
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


def plain_cnn_grads(roi, dE, p_cnn, standardize, dtype):
    """The plain version's weight gradients of sum(out * dE), autograd
    through the plain ROI CNN in ``dtype`` (TF32 off), as a flat vector in
    the kernels' layout."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_cnn

    leaves = {k: {n: t.detach().to(dtype).requires_grad_(True)
                  for n, t in v.items()} for k, v in p_cnn.items()}
    with full_f32():
        out = cuda_cnn.roi_cnn_train_plain(roi, leaves, standardize)
        flat_leaves = [t for v in leaves.values() for t in v.values()]
        grads = iter(torch.autograd.grad(out, flat_leaves, dE.to(dtype)))
    return cuda_cnn.flat_weights({k: {n: next(grads) for n in v}
                                  for k, v in leaves.items()})


def check_k3(p_cnn, flat, gen, dev) -> tuple[float, float]:
    """K3 against the plain version; returns (max abs, max rel) error
    against the f32 plain version over the cases. Raises on a failure.

    On the JAX test's inputs (random frames with the constant tie frames)
    K3 must be within BAR_K3 of the f32 plain version. At N=1000 and 8192,
    where two f32 implementations route some near-tied pool windows
    differently, it must be within BAR_K3_ROUTING of both the f32 plain
    version and its float64 evaluation."""
    from silent_speech_tpu_torch.ops import cuda_cnn

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
    N=8192, on a ragged N=33 with frames of 0 and 255, at N=1 and on
    constant frames only; with and without the standardization, except K4
    (serving only). Then K4 on sub-batches of 33 frames: each row bitwise
    the row of the whole batch. Returns each kernel's largest error; raises
    on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import (cuda_cnn, cuda_cnn_im2col,
                                             cuda_cnn_q8)

    rand = lambda n: torch.randint(0, 256, (n, 48, 96), generator=gen,
                                   dtype=torch.uint8)
    const = lambda vals: torch.tensor(vals, dtype=torch.uint8)[
        :, None, None].expand(len(vals), 48, 96)
    cases = [("N=8192", rand(B_SERVE * T_SERVE)),
             ("N=33 (frames 0, 255 at the end)",
              torch.cat([rand(31), const([0, 255])])),
             ("N=1", rand(1)), ("N=4 constant 0, 0, 255, 255",
                                const([0, 0, 255, 255]))]
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
                BAR_CNN_STD if std else BAR_CNN_LIVE))
        got = cuda_cnn_q8.roi_cnn_q8(roi, p_cnn, impl="kernel",
                                     packed=packs["roi_cnn_q8"])
        ref = cuda_cnn_q8.roi_cnn_q8_plain(roi, packs["roi_cnn_q8"])
        errs["roi_cnn_q8"] = max(errs["roi_cnn_q8"], check_close(
            f"roi_cnn_q8 {label}", got, ref, BAR_Q8))
    roi = torch.cat([rand(31), const([0, 255])]).to(dev)
    whole = cuda_cnn_q8.roi_cnn_q8(roi, p_cnn, impl="kernel",
                                   packed=packs["roi_cnn_q8"])
    for lo, hi in ((0, 1), (5, 6), (3, 17), (20, 33), (31, 33)):
        part = cuda_cnn_q8.roi_cnn_q8(roi[lo:hi].contiguous(), p_cnn,
                                      impl="kernel",
                                      packed=packs["roi_cnn_q8"])
        if not torch.equal(part, whole[lo:hi]):
            fail(f"roi_cnn_q8: frames {lo}:{hi} alone differ from the same "
                 "frames in a batch of 33")
    print("  roi_cnn_q8: frames 0:1, 5:6, 3:17, 20:33, 31:33 alone are "
          "bitwise the same frames in a batch of 33")
    return errs


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
    """One train step (forward, loss, backward, clip, Adam) from the same
    weights through the kernels and through the plain path; raises unless
    the loss, every gradient and every post-step parameter agree and every
    gradient is nonzero."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.models.bigru import BiGRUClassifier
    from silent_speech_tpu_torch.ops import _kernels
    from silent_speech_tpu_torch.train.step import (make_optimizer,
                                                    smoothed_cross_entropy)

    X, L, R, y = batch
    res = {}
    for impl in ("kernel", "plain"):
        model = BiGRUClassifier.from_jax_params(params, cfg).to(dev)
        opt = make_optimizer(model, 3e-4)
        before = _kernels.launch_counts()
        with full_f32():
            logits = model.train_forward(
                X, L, R, generator=torch.Generator(device=dev),
                roi_impl=impl)
            loss = smoothed_cross_entropy(logits, y, cfg.num_classes, 0.05)
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
            fail(f"train step roi_impl={impl}: launches {launched}")
        zero = [n for n, g in grads.items() if not g.abs().max() > 0]
        if zero:
            fail(f"train step roi_impl={impl}: zero gradient for {zero}")
        res[impl] = (loss.item(), grads,
                     {n: p.detach().clone()
                      for n, p in model.named_parameters()})
    (lk, gk, pk), (lp, gp, pp) = res["kernel"], res["plain"]
    diff = {"loss": abs(lk - lp),
            "grad": max((gk[n] - gp[n]).abs().max().item() for n in gk),
            "param": max((pk[n] - pp[n]).abs().max().item() for n in pk)}
    print(f"  train step B={X.shape[0]} T={X.shape[1]} kernels vs plain: "
          f"loss {lk:.6f} vs {lp:.6f} (|d| {diff['loss']:.2e}, bar "
          f"{BAR_LOSS:g}), grads max |d| {diff['grad']:.2e} (bar "
          f"{BAR_GRAD:g}), params after Adam max |d| {diff['param']:.2e} "
          f"(bar {BAR_PARAM:g}); every gradient nonzero")
    for key, bar in (("loss", BAR_LOSS), ("grad", BAR_GRAD),
                     ("param", BAR_PARAM)):
        if not diff[key] <= bar:
            fail(f"train step {key} differs by {diff[key]:.2e} > {bar:g}")


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


def gru_library_ms(p: dict, x: torch.Tensor, lengths: torch.Tensor,
                   iters: int, bidirectional: bool = True) -> float:
    """torch.nn.GRU (cuDNN), one bidirectional (or forward) layer with the
    weights of each direction set to ``p``, on the packed sequence."""
    from torch.nn.utils.rnn import pack_padded_sequence

    D, H = x.shape[-1], p["wh"].shape[0]
    gru = torch.nn.GRU(D, H, batch_first=True,
                       bidirectional=bidirectional).to(x.device)
    with torch.no_grad():
        for sfx in ("l0", "l0_reverse")[:1 + bidirectional]:
            getattr(gru, f"weight_ih_{sfx}").copy_(p["wi"].t())
            getattr(gru, f"weight_hh_{sfx}").copy_(p["wh"].t())
            getattr(gru, f"bias_ih_{sfx}").copy_(p["bi"])
            getattr(gru, f"bias_hh_{sfx}").copy_(p["bh"])
    lens = lengths.cpu()

    def run():
        with torch.no_grad():
            gru(pack_padded_sequence(x, lens, batch_first=True,
                                     enforce_sorted=False))
    return cuda_ms(run, iters)


def check_gru_probes(gen, dev) -> dict:
    """The GRU probes' kernels against their plain versions (TF32 off): the
    recurrence kernel with one weight set (P2a) and two (P2b), K2's
    one-direction launch as proto_gru3's route (P3, f32: K2 has no bf16
    build) and the dual-chain kernel (P4), at B in PROBE_B, T=32, lengths
    that include T and 1, D in PROBE_D, with and without bf16_mm. Returns
    each kernel's largest error; raises on a failure."""
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
                    knobs = REC_KNOBS[bf16]
                    ref_f = gp.gru_recurrence_plain(xp_f, L, pf["wh"],
                                                    pf["bh"], bf16)
                    ref_b = gp.gru_recurrence_plain(xp_b, L, pb["wh"],
                                                    pb["bh"], bf16)
                    got = gp.gru_sequence_kstep(xp_f, L, pf["wh"], pf["bh"],
                                                bf16_mm=bf16, impl="kernel",
                                                **knobs)
                    check("gru_kstep", label, got, ref_f, bar)
                    got = gp.gru_sequence_kstep_2w(
                        torch.cat([xp_f, xp_b]), L.repeat(2), wh2, bh2,
                        bf16_mm=bf16, impl="kernel", **knobs)
                    check("gru_kstep_2w", label, got,
                          torch.cat([ref_f, ref_b]), bar)
                    got = gp.gru_layer_dual(x, x_flip, L, pf, pb,
                                            bf16_mm=bf16, impl="kernel")
                    ref = gp.gru_layer_dual_plain(x, x_flip, L, pf, pb, bf16)
                    for half, g, r in zip(("y_f", "y_b"), got, ref):
                        check("gru_dual", f"{label} {half}", g, r, bar)
    return errs


def time_gru_probes(dev, card: str) -> dict:
    """Each probe kernel, its plain version and cuDNN's layer at B=512 and
    B=1, T=32, D=180 (the scripts' inputs), CUDA events; each kernel's
    bound over this run's lengths. Returns {kernel: {key: value}}."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_gru_proto as gp
    from silent_speech_tpu_torch.ops import gru as gru_ops
    from silent_speech_tpu_torch.scripts import bench_gru, proto_gru3

    T, H = PROBE_T, PROBE_H
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
        lib_uni = ("forward", gru_library_ms(pf, x, L.cpu(), 20,
                                             bidirectional=False))
        lib_bi = ("bidirectional", gru_library_ms(pf, x, L.cpu(), 20))
        rec_bytes = 4 * (B * T * 4 * H + H * 3 * H + 3 * H + B)
        proj_bytes = 4 * (B * T * (D + H) + (D + H) * 3 * H + 6 * H + B)
        cases = {  # kernel: (run(bf16), plain, ops, bytes, (library, ms))
            "gru_kstep": (
                lambda bf16: gp.gru_sequence_kstep(
                    xp_f, L, pf["wh"], pf["bh"], bf16_mm=bf16,
                    impl="kernel", **REC_KNOBS[bf16]),
                lambda: gp.gru_recurrence_plain(xp_f, L, pf["wh"], pf["bh"]),
                2 * S * H * 3 * H, rec_bytes, lib_uni),
            "gru_kstep_2w": (
                lambda bf16: gp.gru_sequence_kstep_2w(
                    xp2, L2, wh2, bh2, bf16_mm=bf16, impl="kernel",
                    **REC_KNOBS[bf16]),
                lambda: torch.cat([gp.gru_recurrence_plain(
                    xp2[s * B:(s + 1) * B], L, wh2[s], bh2[s])
                    for s in (0, 1)]),
                2 * 2 * S * H * 3 * H, 2 * rec_bytes, lib_bi),
            "gru_fusedproj": (
                lambda bf16: proto_gru3.gru_sequence_fusedproj(
                    x, L, pf["wi"], pf["bi"], pf["wh"], pf["bh"],
                    impl="kernel"),
                lambda: gru_ops.gru_layer_single_direction(x, L, pf)[0],
                2 * S * (D + H) * 3 * H, proj_bytes, lib_uni),
            "gru_dual": (
                lambda bf16: gp.gru_layer_dual(x, x_flip, L, pf, pb,
                                               bf16_mm=bf16, impl="kernel"),
                lambda: gp.gru_layer_dual_plain(x, x_flip, L, pf, pb),
                2 * 2 * S * (D + H) * 3 * H,
                4 * (2 * B * T * (D + H) + 2 * ((D + H) * 3 * H + 6 * H)
                     + B), lib_bi),
        }
        sfx = "" if B == 512 else "_b1"
        for name, (run, plain, ops, nbytes, lib) in cases.items():
            r = out[name]
            r["ms" + sfx] = cuda_ms(lambda: run(False), 20)
            with full_f32():
                r["plain_ms" + sfx] = cuda_ms(plain, 5, warmup=1)
            r["bound_ms" + sfx], r["bound_by" + sfx] = bound_ms(ops, nbytes)
            r["library_ms" + sfx] = lib[1]
            line = (f"  {name} B={B} T={T} D={D}: kernel {r['ms' + sfx]:.4f}"
                    f" ms, plain {r['plain_ms' + sfx]:.4f} ms, bound "
                    f"{r['bound_ms' + sfx]:.4f} ms ({r['bound_by' + sfx]}), "
                    f"torch.nn.GRU {lib[0]} layer (cuDNN, projection "
                    f"included) {lib[1]:.4f} ms")
            if name != "gru_fusedproj":  # K2 has no bf16 build
                r["ms_bf16" + sfx] = cuda_ms(lambda: run(True), 20)
                r["bound_ms_bf16" + sfx] = bound_ms(ops, nbytes,
                                                    PEAK_BF16_FLOPS)[0]
                line += (f"; bf16_mm {r['ms_bf16' + sfx]:.4f} ms (bound "
                         f"{r['bound_ms_bf16' + sfx]:.4f} at the bf16 rate)")
            print(line + f" {card}")
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
    want = {script: {"gru_seq"} for script in PROBE_SCRIPTS}  # baselines
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


def check_cnn_front(dev) -> dict:
    """The CNN-front prototypes' kernels against their plain versions (TF32
    off): the parity kernel in both layouts at N in (16, FRONT_N) with
    packed and random weights, all-0 and all-255 frames among them; its
    ablation's ``full`` bitwise the kernel; each probe stage's per-block
    value; K1's debug stops, live and standardized. Returns each kernel's
    largest errors ({name: {key: value}}); raises on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.models.bigru import init_roi_cnn
    from silent_speech_tpu_torch.ops import cuda_cnn
    from silent_speech_tpu_torch.ops import cuda_front_probe as fp
    from silent_speech_tpu_torch.ops import cuda_parity_cnn as pc

    rng = np.random.default_rng(SEED + 9)
    errs = {name: {"max_abs_err": 0.0} for name in FRONT_KERNELS}

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
            if not all(torch.equal(a, b) for a, b in zip(full, halves)):
                fail(f"parity_ablate full differs from the kernel ({label})")
            print(f"  parity_ablate full {label}: bitwise the kernel")
            if kind == "packed":  # and the plain conv1 + pool1 itself
                k = torch.stack([torch.stack([w[0][dy * 34 + dx, :8]
                                              for dx in range(3)])
                                 for dy in range(3)])[:, :, None] * 255.0
                with full_f32():
                    conv = pc.ref_conv1pool1(roi, k, w[2][0, :8])
                check_close(f"conv1pool1 {label} vs plain conv1+pool1", one,
                            conv, BAR_PARITY)

    roi_np = rng.integers(0, 256, (FRONT_N, 48, 96), dtype=np.uint8)
    roi_np[0], roi_np[1] = 0, 255
    x = torch.from_numpy(roi_np.reshape(-1, 384))
    x_small = torch.from_numpy(rng.integers(0, 256, (FRONT_N, 4),
                                            dtype=np.uint8))
    for stage in fp.STAGES:
        for F in (fp.DMA_FRAMES if stage == "dma" else (1,)):
            xi = x_small if stage == "overlap_b" else x
            got = fp.probe(stage, xi.to(dev), F).cpu().double()
            want = fp.probe_plain(stage, xi, F).double()
            err = (got - want).abs()
            bar = fp.bar(stage, xi, F).double()
            print(f"  roi_front_probe {stage} F={F}: max difference per "
                  f"block {err.max().item():.3e} (bar: 1e-5 of each "
                  f"moment's sum of |terms|, 0 for integer sums)")
            if (err > bar).any():
                fail(f"roi_front_probe {stage} F={F}: {int((err > bar).sum())}"
                     " blocks off the plain version")
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
                    got, ref, BAR_CNN_STD if std else BAR_CNN_LIVE)
    return errs


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
    roi, xs, w = parity_inputs(N, "packed", rng, dev)
    flat = [x.reshape(-1, 96) for x in xs]
    in_bytes, out_bytes = N * 48 * 96, 4 * N * 12 * 768
    w_bytes = 4 * (2 * 104 * 128 + 384)
    p_bound = bound_ms(2 * N * PARITY_MACS, in_bytes + out_bytes + w_bytes)
    p_bound_taps = bound_ms(2 * N * 48 * 96 * 8 * 9,
                            in_bytes + out_bytes + w_bytes)[0]
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
        r["bound_ms_9_taps"] = p_bound_taps
        r["library_ms"] = None
        print(f"  {name} N={N}: kernel {r['ms']:.4f} ms, plain (through WE, "
              f"WO) {plain_ms:.4f} ms, plain conv1+ReLU+pool1 (cuDNN, three "
              f"calls) {conv_ms:.4f} ms, bound {p_bound[0]:.4f} ms "
              f"({p_bound[1]}; the 9 useful taps alone {p_bound_taps:.4f}); "
              f"no single PyTorch call computes it {card}")
    r = out["parity_ablate"]
    io_bound = bound_ms(0, in_bytes + out_bytes)
    r["bound_ms_io_only"] = io_bound[0]
    for mode in ("io_only", "widen_only", "halo_only", "no_dot"):
        fn = lambda: pc.run(*flat, *w, mode=mode, impl="kernel")
        r[f"ms_{mode}"] = timed(fn, p_bound[1])
        print(f"  parity_ablate {mode}: {r[f'ms_{mode}']:.4f} ms {card}")

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
            key = stage if F == 1 else f"{stage}_f{F}"
            macs = N * fp.THREADS * fp.CHAIN_ACC * fp.CHAIN_LEN \
                if stage.startswith("overlap") else 0
            blocks = N // F
            b_ms, b_by = bound_ms(
                2 * macs, (0 if stage == "overlap_b" else in_bytes)
                + 4 * blocks * (1 if stage in fp.SCALAR else 3))
            r[f"bound_ms_{key}"], r[f"bound_by_{key}"] = b_ms, b_by
            r[f"ms_{key}"] = timed(lambda: fp.probe(stage, xi, F), b_by)
            print(f"  roi_front_probe {key}: {r[f'ms_{key}']:.4f} ms"
                  f"{' (cold L2)' if b_by == 'bytes' else ''}, bound "
                  f"{b_ms:.4f} ms ({b_by}) {card}")
    r["ms"], r["bound_ms"], r["bound_by"] = \
        r["ms_dma"], r["bound_ms_dma"], "bytes"
    r["plain_ms"] = timed(lambda: fp.probe_plain("dma", x), "bytes")
    r["library_ms"] = None
    print(f"  roi_front_probe dma: plain {r['plain_ms']:.4f} ms {card}")

    p = {k_: {n: t.to(dev) for n, t in v.items()}
         for k_, v in init_roi_cnn(32, torch.Generator().manual_seed(SEED + 10))
         .items()}
    pflat = cuda_cnn.flat_weights(p)
    r = out["roi_cnn_debug"]
    r["k1_ms"] = timed(lambda: cuda_cnn.roi_cnn_fused(
        roi, p, impl="kernel", flat=pflat), "operations")
    io = in_bytes + 4 * N * 32 + 4 * pflat.numel()
    for stop in cuda_cnn.DEBUG_STOPS:
        b_ms, b_by = bound_ms(2 * N * STOP_MACS[stop], io)
        r[f"bound_ms_{stop}"], r[f"bound_by_{stop}"] = b_ms, b_by
        r[f"ms_{stop}"] = timed(
            lambda: cuda_cnn.roi_cnn_fused(roi, p, impl="kernel", flat=pflat,
                                           debug_stop=stop), b_by)
    with full_f32():
        r["plain_ms"] = timed(lambda: cuda_cnn.roi_cnn_debug_plain(
            roi, p, False, "load"), "bytes")
    r["ms"], r["bound_ms"], r["bound_by"] = \
        r["ms_load"], r["bound_ms_load"], r["bound_by_load"]
    r["library_ms"] = None
    print(f"  K1 N={N}: {r['k1_ms']:.4f} ms (PERF.md section 6: 5.3285 ms); "
          "debug stops " + ", ".join(
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
    element's sum of |terms| (ops/cuda_mm_rate.BAR_DEPTH); DC in every mode
    at K=384 and 512, 256 steps and 3, its check instantiation's output and
    moments bitwise for int8 / int8i and within 1e-5 (f32) or 2e-2 (bf16,
    rounding flips) of each value's sum of |terms|
    (ops/cuda_dot_chain.compare), in bf16 its traced rows product by
    product (ops/cuda_dot_chain.check_rounding, with two controls that must
    fail it: the chain held in f32 and in f16 between products), and the
    timed instantiation's output bitwise the check instantiation's; LP's
    nine bodies at 512 steps and 2,
    bitwise but the product (4 sqrt(512) 2^-24 of each sum of |terms|;
    scripts/mosaic_micro.check_body), the unaligned body on its written
    lanes with zeros in the rest. Returns {kernel: {key: value}}; raises on
    a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_dot_chain as dc
    from silent_speech_tpu_torch.ops import cuda_layout_micro as lm
    from silent_speech_tpu_torch.ops import cuda_mm_rate as mr
    from silent_speech_tpu_torch.scripts import mosaic_micro

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
        rng = np.random.default_rng(SEED + 11)
        for steps in (dc.GRID, 3):
            x = torch.from_numpy(rng.integers(0, 256, (steps * 8, 128),
                                              dtype=np.uint8)).to(dev)
            for K in dc.KS:
                for mode in dc.MODES:
                    w = dc.make_weights(mode, K).to(dev)
                    note("dot_chain", f"{mode} K={K} steps={steps}",
                         dc.check(x, w, mode))
                    if mode != "bf16":
                        continue
                    for keep in (torch.float32, torch.float16):
                        bad = dc.rounding_outside(dc.trace_plain(x, w, keep),
                                                  x, w)
                        print(f"  dot_chain bf16 K={K} steps={steps}, control"
                              f" held in {keep}: {bad} traced values outside "
                              "their windows")
                        if not bad:
                            fail(f"dot_chain bf16: the control held in {keep}"
                                 " passed the rounding check")
        for steps in (lm.STEPS, 2):
            x = torch.from_numpy(rng.standard_normal((steps * lm.R, lm.L))
                                 .astype(np.float32)).to(dev)
            for body in lm.BODIES:
                err = mosaic_micro.check_body(body, x)
                note("layout_micro", f"{body} steps={steps}",
                     {"max_abs_err": err, "share_of_bar": 0.0})
            del x
    return errs


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
            print(f"  {name} {key}: {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {share:.1%} of "
                  f"it; plain {r['plain_ms']:.4f} ms; library "
                  + ("none: no single call" if r["library_ms"] is None
                     else f"{r['library_ms']:.4f} ms") + f" {card}")
            if share > 1.0:
                fail(f"{name} {key}: {r['ms']:.4f} ms is {share:.1%} of its "
                     f"bound {r['bound_ms']:.4f} ms: it did less work than "
                     "the function")
        rates[name] = {**{k: rows[first][k] for k in keys}, "row": first,
                       "rows": {k: {c: v for c, v in r.items() if c != "name"}
                                for k, r in rows.items()}}
    return counts, rates


def check_bwd_dots(dev) -> dict:
    """The backward-dot kernels against their plain versions on the card
    (TF32 off) at the small ragged shape BWD_SMALL (every kind; tt and nn
    also in dots3's form, one 24-row tile over 7 steps), within 4 sqrt(n)
    2^-24 of each element's sum of |terms| (ops/cuda_bwd_dots.compare; nt's
    tail rows exact zeros); tt and base twice on the same full-size
    inputs, bitwise equal. The scripts' rows hold every
    kernel at the full shapes. Returns {kernel: {max_abs_err,
    max_share_of_bar}}; raises on a failure."""
    from silent_speech_tpu_torch.infer.predictor import full_f32
    from silent_speech_tpu_torch.ops import cuda_bwd_dots as bd

    errs = {name: {"max_abs_err": 0.0, "max_share_of_bar": 0.0}
            for name in BWD_KERNELS}

    def note(kind, label, r):
        e = errs[BWD_KIND_KERNEL[kind]]
        e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
        e["max_share_of_bar"] = max(e["max_share_of_bar"], r["share_of_bar"])
        print(f"  {BWD_KIND_KERNEL[kind]} {kind} {label}: max difference "
              f"{r['max_abs_err']:.3e}, {r['share_of_bar']:.3f} of the bar")

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
        p, dy, w = (bd.draw(rng, s, dev) for s in ((bd.ROWS, 512),
                                                    (bd.ROWS, 256),
                                                    (512, 256)))
        for kind, a, b in (("tt", p, dy), ("base", p, w)):
            one, two = bd.run(kind, a, b, m=384), bd.run(kind, a, b, m=384)
            torch.cuda.synchronize()
            if not torch.equal(one, two):
                fail(f"bwd_dot {kind}: two launches on the same inputs "
                     "differ")
            print(f"  {BWD_KIND_KERNEL[kind]} {kind} rows={bd.ROWS} m=384: "
                  "two launches bitwise equal")
    return errs


def run_bwd_dot_scripts(card: str) -> tuple[dict, dict]:
    """The three backward-dot scripts at full size (98,304 rows; dots3 512
    steps), RATE_ITERS timed calls a row (each row first holds its kernel's
    output against the plain version and raises over its bar); the launch
    counts from 0 over each script's run. A row above 100% of its bound
    fails: the bound is the least time the card can take, so a faster row
    did less work than the function asks (a product hoisted out of dots3's
    steps, or base's colsum(p) @ w). Returns ({script: launch counts},
    {kernel: the kernels line's keys, its rows, its launches over the
    three runs}); raises if a kernel of a script's path was not
    launched."""
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
            print(f"  {script} {r['name']}: {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {share:.1%} of "
                  f"it; plain {r['plain_ms']:.4f} ms; library "
                  f"{r['library_ms']:.4f} ms; "
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
        rates[name].update({k: row[k] for k in keys})
        rates[name]["row"] = f"{script}:{first}"
        rates[name]["launches"] = sum(c.get(name, 0)
                                      for c in counts.values())
        rates[name]["rows_max_abs_err"] = max(
            r["max_abs_err"] for r in rates[name]["rows"].values())
        rates[name]["rows_max_share_of_bar"] = max(
            r["share_of_bar"] for r in rates[name]["rows"].values())
    return counts, rates


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
        for std, bar in ((False, BAR_CNN_LIVE), (True, BAR_CNN_STD)):
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

    k3_abs, k3_rel = check_k3(p_cnn, flat,
                              torch.Generator().manual_seed(SEED + 3), dev)
    packs = mode_packs(p_cnn)
    mode_errs = check_serving_kernels(
        p_cnn, packs, torch.Generator().manual_seed(SEED + 4), dev)

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
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["predict", f"ckpt_path={ckpt}",
                       f"clip={work / 'clips' / '*.npz'}", "device=cuda"])
    print(out.getvalue(), end="")
    if rc != 0:
        fail(f"predict CLI exited {rc}")
    pred = Predictor.from_checkpoint(ckpt, device="cuda")
    logits = pred.predict_batch(Xb, Lb, Rb)
    counts = _kernels.launch_counts()
    print(f"  launches on the serving path: {counts}")
    if any(counts[k] <= 0 for k in ("roi_cnn", "gru_seq")):
        fail(f"a kernel of the path was not launched: {counts}")

    cli_lines = out.getvalue().strip().splitlines()
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
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["train", f"clip_dir={corpus}", f"out_path={tr_ckpt}",
                       f"epochs={TRAIN_EPOCHS}", f"lr={TRAIN_LR}",
                       f"batch_size={B_TRAIN}", "device=cuda"])
    train_counts = _kernels.launch_counts()
    print(out.getvalue(), end="")
    if rc != 0:
        fail(f"train CLI exited {rc}")
    text = out.getvalue()
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
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["predict", f"ckpt_path={tr_ckpt}",
                       f"clip={corpus / 'smoke_yes_0_000*.npz'}",
                       "device=cuda"])
    print(out.getvalue(), end="")
    if rc != 0:
        fail(f"predict CLI on the trained checkpoint exited {rc}")
    lines = out.getvalue().strip().splitlines()
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
                any(mode_counts[k] for k in others):
            fail(f"eval-dataset {mode}: launches {launched}, expected "
                 f"{kname} and gru_seq only")
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
    cnn_ms = cuda_ms(lambda: cuda_cnn.roi_cnn_fused(roi, p_cnn, impl="kernel",
                                                    flat=flat), 20)
    with full_f32():
        cnn_plain_ms = cuda_ms(lambda: cuda_cnn.roi_cnn_plain(roi, p_cnn),
                               20)
    N = roi.shape[0]
    cnn_bound, cnn_by = bound_ms(2 * N * (CNN_FWD_MACS + 24 * 32),
                                 N * (48 * 96 + 4 * 32) + 4 * flat.numel())
    print(f"  roi_cnn N={N}: kernel {cnn_ms:.4f} ms, plain "
          f"{cnn_plain_ms:.4f} ms, bound {cnn_bound:.4f} ms "
          f"({cnn_by}) {card}")
    dE = torch.randn(N, 32, generator=gen).to(dev)
    k3_ms = cuda_ms(lambda: cuda_cnn.roi_cnn_weight_grads(
        roi, dE, flat, standardize=True), 10)
    k3_plain_ms = cuda_ms(lambda: plain_cnn_grads(roi, dE, p_cnn, True,
                                                  torch.float32), 5)
    k3_bound, k3_by = bound_ms(
        2 * N * (CNN_FWD_MACS + CNN_BWD_MACS + 3 * 24 * 32),
        N * (48 * 96 + 4 * 32) + 2 * 4 * flat.numel())
    print(f"  roi_cnn_bwd N={N} standardize=True: kernel {k3_ms:.4f} ms, "
          f"plain (autograd through cuDNN, forward included) "
          f"{k3_plain_ms:.4f} ms, bound {k3_bound:.4f} ms ({k3_by}); no "
          f"single PyTorch call computes it {card}")
    from silent_speech_tpu_torch.ops import cuda_cnn_im2col, cuda_cnn_q8
    mode_fns = {  # kernel, plain version, peak rate of the kernel's type
        "roi_cnn_bf16": (
            lambda r: cuda_cnn.roi_cnn_bf16(r, p_cnn, impl="kernel",
                                            flat=packs["roi_cnn_bf16"]),
            lambda r: cuda_cnn.roi_cnn_bf16_plain(r, p_cnn),
            PEAK_BF16_FLOPS, 4 * packs["roi_cnn_bf16"].numel()),
        "roi_cnn_q8": (
            lambda r: cuda_cnn_q8.roi_cnn_q8(r, p_cnn, impl="kernel",
                                             packed=packs["roi_cnn_q8"]),
            lambda r: cuda_cnn_q8.roi_cnn_q8_plain(r, packs["roi_cnn_q8"]),
            PEAK_INT8_OPS, 4 * (packs["roi_cnn_q8"]["qi"].numel()
                                + packs["roi_cnn_q8"]["qf"].numel())),
        "roi_cnn_im2col": (
            lambda r: cuda_cnn_im2col.roi_cnn_im2col(
                r, p_cnn, impl="kernel", packed=packs["roi_cnn_im2col"]),
            lambda r: cuda_cnn.roi_cnn_plain(r, p_cnn),
            PEAK_F32_FLOPS, 4 * packs["roi_cnn_im2col"].numel())}
    mode_ms = {}
    for kname, (kfn, pfn, peak, wbytes) in mode_fns.items():
        for Nm in (B_SWEEP * 90, N):
            r = roi[:Nm]
            k_ms = cuda_ms(lambda: kfn(r), 10)
            with full_f32():
                p_ms = cuda_ms(lambda: pfn(r), 3, warmup=1)
            b_ms, b_by = bound_ms(2 * Nm * (CNN_FWD_MACS + 24 * 32),
                                  Nm * (48 * 96 + 4 * 32) + wbytes, peak)
            mode_ms[kname, Nm] = (k_ms, p_ms, b_ms, b_by)
            print(f"  {kname} N={Nm}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); no single "
                  f"PyTorch call computes it {card}")
    Xf, Lf, Rf = Xs_[:B_SWEEP], Ls_[:B_SWEEP], Rs_[:B_SWEEP]
    for mode, pr in mode_pred.items():
        ms = cuda_ms(lambda: pr.predict_batch(Xf, Lf, Rf), 10)
        print(f"  predict_batch {mode} B={B_SWEEP} T=90 (the sweep's "
              f"batches, host arrays in and out): {ms:.4f} ms, "
              f"{B_SWEEP / ms * 1e3:.1f} clips/s {card}")
    x = torch.randn(B_SERVE, T_SERVE, 212, generator=gen).to(dev)
    layer = [{"fwd": gru_p[212], "bwd": gru_p[212]}]
    Ld = lengths.to(dev)
    gru_ms = cuda_ms(lambda: cuda_gru.bigru_kernel(x, Ld, layer,
                                                   impl="kernel"), 20)
    with full_f32():
        gru_plain_ms = cuda_ms(lambda: gru_ops.bigru(x, Ld, layer), 20)
    gru_lib_ms = gru_library_ms(gru_p[212], x, lengths, 20)
    gru_lib_b1_ms = gru_library_ms(gru_p[212], x[:1],
                                   torch.tensor([T_SERVE]), 20)
    H = 192
    gru_bound, gru_by = bound_ms(
        2 * 2 * int(lengths.sum()) * (212 + H) * 3 * H,
        4 * (x.numel() + 2 * ((212 + H) * 3 * H + 6 * H)
             + B_SERVE * T_SERVE * 2 * H))
    print(f"  gru_seq one bidirectional layer B={B_SERVE} T={T_SERVE} D=212:"
          f" kernel {gru_ms:.4f} ms, plain {gru_plain_ms:.4f} ms, "
          f"torch.nn.GRU (cuDNN, packed) {gru_lib_ms:.4f} ms, bound "
          f"{gru_bound:.4f} ms ({gru_by}); torch.nn.GRU at B=1 T={T_SERVE} "
          f"{gru_lib_b1_ms:.4f} ms {card}")
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
        bd = device_breakdown(lambda: pred.predict_batch(Xs, Ls, Rs))
        if bd["busy_ms"] is None:
            print(f"  B={B}: wall {bd['wall_ms']:.4f} ms; device time not "
                  "measured (the profiler recorded no device events)")
            continue
        cats = ", ".join(f"{k} {v:.4f}" for k, v in
                         sorted(bd["device_ms"].items(), key=lambda kv: -kv[1]))
        print(f"  B={B}: wall {bd['wall_ms']:.4f} ms, device busy "
              f"{bd['busy_ms']:.4f} ms, idle share {bd['idle_share']:.4f}; "
              f"{cats}")

    print(f"device breakdown, predict_batch per serving mode, B={B_SWEEP} "
          f"T=90 (the sweep's batches), ms per call {card}:")
    for mode, pr in mode_pred.items():
        bd = device_breakdown(lambda: pr.predict_batch(Xf, Lf, Rf))
        if bd["busy_ms"] is None:
            print(f"  {mode}: wall {bd['wall_ms']:.4f} ms; device time not "
                  "measured")
            continue
        cats = ", ".join(f"{k} {v:.4f}" for k, v in
                         sorted(bd["device_ms"].items(), key=lambda kv: -kv[1]))
        print(f"  {mode}: wall {bd['wall_ms']:.4f} ms, device busy "
              f"{bd['busy_ms']:.4f} ms, idle share {bd['idle_share']:.4f}; "
              f"{cats}")

    print(f"device breakdown, train step (kernels) B={B_SERVE} "
          f"T={T_SERVE}, ms per step, mean of 3 profiled steps {card}:")
    bd = device_breakdown(train_step_fn(
        params_t, cfg_t, train_batch(cfg_t, B_SERVE, T_SERVE, rng, dev), dev,
        "kernel"))
    if bd["busy_ms"] is None:
        print(f"  wall {bd['wall_ms']:.4f} ms; device time not measured")
    else:
        cats = ", ".join(f"{k} {v:.4f}" for k, v in
                         sorted(bd["device_ms"].items(), key=lambda kv: -kv[1]))
        print(f"  wall {bd['wall_ms']:.4f} ms, device busy "
              f"{bd['busy_ms']:.4f} ms, idle share {bd['idle_share']:.4f}; "
              f"{cats}")

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

    # ---- 11. the backward-dot probes: kernels vs plain, the scripts
    print("backward-dot probes, kernel vs plain (TF32 off):")
    bwd_errs = check_bwd_dots(dev)
    print(f"backward-dot probes, the scripts at full size, {RATE_ITERS} timed "
          f"calls a row {card}:")
    _, bwd_ms = run_bwd_dot_scripts(card)

    result = {"kernels": [
        {"name": "roi_cnn", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/roi_cnn.cu",
         "replaces": "silent_speech_tpu/ops/pallas_cnn2.py:1018",
         "launches": counts["roi_cnn"], "max_abs_err": cnn_err,
         "ms": cnn_ms, "plain_ms": cnn_plain_ms, "bound_ms": cnn_bound,
         "bound_by": cnn_by, "library_ms": None},
        {"name": "gru_seq", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/gru_seq.cu",
         "replaces": "silent_speech_tpu/ops/pallas_gru.py:165",
         "launches": counts["gru_seq"], "max_abs_err": gru_err,
         "ms": gru_ms, "plain_ms": gru_plain_ms, "bound_ms": gru_bound,
         "bound_by": gru_by, "library_ms": gru_lib_ms},
        {"name": "roi_cnn_bwd", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/roi_cnn_bwd.cu",
         "replaces": "silent_speech_tpu/ops/pallas_cnn2_grad.py:319",
         "launches": train_counts["roi_cnn_bwd"], "max_abs_err": k3_abs,
         "max_rel_err": k3_rel, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
    ]}
    for kname, mode, replaces in (
            ("roi_cnn_bf16", "bf16", "silent_speech_tpu/ops/pallas_cnn2.py:1018"),
            ("roi_cnn_q8", "q8", "silent_speech_tpu/ops/pallas_cnn2.py:937"),
            ("roi_cnn_im2col", "im2col", "silent_speech_tpu/ops/pallas_cnn.py:328")):
        k_ms, p_ms, b_ms, b_by = mode_ms[kname, N]
        k_sweep, p_sweep, b_sweep, _ = mode_ms[kname, B_SWEEP * 90]
        source = "roi_cnn.cu" if kname == "roi_cnn_bf16" else f"{kname}.cu"
        result["kernels"].append({
            "name": kname, "route": "cuda",
            "source": f"silent_speech_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": sweep[mode]["launches"],
            "max_abs_err": mode_errs[kname], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_sweep_shape": k_sweep, "plain_ms_sweep_shape": p_sweep,
            "bound_ms_sweep_shape": b_sweep,
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
    for kname, (replaces, _) in BWD_KERNELS.items():
        r, e = bwd_ms[kname], bwd_errs[kname]
        result["kernels"].append({
            "name": kname, "route": "cuda",
            "source": "silent_speech_tpu_torch/csrc/bwd_dots.cu",
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": max(e["max_abs_err"], r["rows_max_abs_err"]),
            "share_of_bar": max(e["max_share_of_bar"],
                                r["rows_max_share_of_bar"]),
            **{k: v for k, v in r.items() if k not in (
                "launches", "rows_max_abs_err", "rows_max_share_of_bar")}})
    print(json.dumps(result))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
