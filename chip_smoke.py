#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (silent_speech_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero and
prints no result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the kernels from silent_speech_tpu_torch/csrc/*.cu with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   serving shapes, TF32 off for the plain version;
4. the serving path at full width (random weights from a seed): the
   ``predict`` CLI on clips of 5..90 frames, and ``Predictor.predict_batch``
   at B=256, T=32 against the plain path on the card and on the CPU, with
   the kernels' launch counts over that run;
5. timings with CUDA events: each kernel and its plain version, serving
   clips/s at B=256 and B=1024 (T=32), p50 latency at B=1;
6. a torch.profiler pass over ``predict_batch`` at B=1, 256 and 1024
   (T=32): device time by kernel and copy, and the device's idle share.

Then one JSON line with the kernels' results, and last
``{"ok": true, "device": {...}}``. Needs one CUDA device; refuses to run
without one. Scratch files go under build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
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
B_SERVE, T_SERVE = 256, 32


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
    from silent_speech_tpu_torch.train.checkpoint import (
        reference_meta, save_checkpoint)

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

    # ---- 5. timings (CUDA events)
    print(f"timings {card}:")
    roi = torch.randint(0, 256, (B_SERVE * T_SERVE, 48, 96), generator=gen,
                        dtype=torch.uint8).to(dev)
    cnn_ms = cuda_ms(lambda: cuda_cnn.roi_cnn_fused(roi, p_cnn, impl="kernel",
                                                    flat=flat), 20)
    with full_f32():
        cnn_plain_ms = cuda_ms(lambda: cuda_cnn.roi_cnn_plain(roi, p_cnn),
                               20)
    print(f"  roi_cnn N={roi.shape[0]}: kernel {cnn_ms:.4f} ms, plain "
          f"{cnn_plain_ms:.4f} ms {card}")
    x = torch.randn(B_SERVE, T_SERVE, 212, generator=gen).to(dev)
    layer = [{"fwd": gru_p[212], "bwd": gru_p[212]}]
    Ld = lengths.to(dev)
    gru_ms = cuda_ms(lambda: cuda_gru.bigru_kernel(x, Ld, layer,
                                                   impl="kernel"), 20)
    with full_f32():
        gru_plain_ms = cuda_ms(lambda: gru_ops.bigru(x, Ld, layer), 20)
    print(f"  gru_seq one bidirectional layer B={B_SERVE} T={T_SERVE} D=212:"
          f" kernel {gru_ms:.4f} ms, plain {gru_plain_ms:.4f} ms {card}")
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

    # ---- 6. where the time goes (torch.profiler), kernels path
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

    result = {"kernels": [
        {"name": "roi_cnn", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/roi_cnn.cu",
         "replaces": "silent_speech_tpu/ops/pallas_cnn2.py:1018",
         "launches": counts["roi_cnn"], "max_abs_err": cnn_err,
         "ms": cnn_ms, "plain_ms": cnn_plain_ms},
        {"name": "gru_seq", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/gru_seq.cu",
         "replaces": "silent_speech_tpu/ops/pallas_gru.py:165",
         "launches": counts["gru_seq"], "max_abs_err": gru_err,
         "ms": gru_ms, "plain_ms": gru_plain_ms},
    ]}
    print(json.dumps(result))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
