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
   twice on the same inputs (bitwise-equal);
4. the serving path at full width (random weights from a seed): the
   ``predict`` CLI on clips of 5..90 frames, and ``Predictor.predict_batch``
   at B=256, T=32 against the plain path on the card and on the CPU, with
   the kernels' launch counts over that run;
5. the training path at full width: the ``train`` CLI for 2 epochs at
   batch 16 on a synthetic corpus (10 words x 8 clips of 20..90 frames),
   with the kernels' launch counts over that run, then ``predict`` on its
   checkpoint; and one train step (B=16, T=90, no dropout or augmentation)
   through the kernels against the plain path;
6. timings with CUDA events: each kernel, its plain version and, where one
   exists, the PyTorch library call for the same function; each kernel's
   bound; serving clips/s at B=256 and B=1024 (T=32), p50 latency at B=1;
   train steps at B=16, T=90 and B=256, T=32;
7. a torch.profiler pass over ``predict_batch`` at B=1, 256 and 1024
   (T=32) and over the B=256 train step: device time by kernel and copy,
   and the device's idle share.

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
B_SERVE, T_SERVE = 256, 32
B_TRAIN, T_TRAIN = 16, 90  # the reference protocol (core/config.py)
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): f32 on
# the CUDA cores and HBM bandwidth
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# multiply-adds per frame: the ROI CNN forward (convs + fc at emb=32) and
# what K3 adds to recompute it (fc and d feat, conv3 weight grads and
# transposed conv, conv2 and conv1 grads over the routed cells only)
CNN_FWD_MACS = 48 * 96 * 8 * 9 + 24 * 48 * 16 * 8 * 9 + 12 * 24 * 24 * 16 * 9
CNN_BWD_MACS = (2 * 24 * 16 * 9 * 288 + 2 * 16 * 8 * 9 * 288
                + 8 * 9 * 24 * 48)


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work on the card: the larger of the f32
    operations over the f32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
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


def write_train_corpus(out_dir: Path, words: list[str], per_word: int
                       ) -> None:
    """Synthetic clips of 20..90 frames through the port's data/synthetic.py,
    in the reference clip format."""
    from silent_speech_tpu_torch.core.schema import (Clip, clip_filename,
                                                     save_clip)
    from silent_speech_tpu_torch.data.synthetic import synthetic_clip

    rng = np.random.default_rng(SEED)
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
                   iters: int) -> float:
    """torch.nn.GRU (cuDNN), one bidirectional layer with the weights of
    both directions set to ``p``, on the packed sequence."""
    from torch.nn.utils.rnn import pack_padded_sequence

    D, H = x.shape[-1], p["wh"].shape[0]
    gru = torch.nn.GRU(D, H, batch_first=True, bidirectional=True).to(x.device)
    with torch.no_grad():
        for sfx in ("l0", "l0_reverse"):
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
                       "epochs=2", f"batch_size={B_TRAIN}", "device=cuda"])
    train_counts = _kernels.launch_counts()
    print(out.getvalue(), end="")
    if rc != 0:
        fail(f"train CLI exited {rc}")
    text = out.getvalue()
    for ep in (1, 2):
        m = re.search(rf"^ep {ep:02d} \| train loss (\S+) acc \S+ \| val "
                      rf"loss (\S+) acc ", text, re.M)
        if m is None or not all(math.isfinite(float(v)) for v in m.groups()):
            fail(f"train CLI printed no 'ep {ep:02d} |' line with finite "
                 "losses")
    n_train = int(re.search(r"^Train clips: (\d+)", text, re.M).group(1))
    steps = 2 * -(-n_train // B_TRAIN)
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
    print(json.dumps(result))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
