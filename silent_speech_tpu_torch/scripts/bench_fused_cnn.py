"""Probe: the fused ROI CNN kernel against the plain CNN, its stage
ablation, the end-to-end live forward, and the matmul rate at the CNN's
packed shapes (port of scripts/bench_fused_cnn.py).

    python -m silent_speech_tpu_torch.scripts.bench_fused_cnn [mxu|ftile] \\
        [N] [device=cuda] [iters=30]

``mxu`` (``probe_mxu``): for each of the JAX script's six (M, K, N) shapes,
the sum of 64 products of A, lane-rolled by ``r % 8``, with B, in each of
64 steps (ops/cuda_mm_rate.py, csrc/mm_rate.cu, 3xTF32 on wgmma), held
against its plain version, then timed: T MAC/s, the share of the bound at
232 TFLOP/s (the f32 FMAs and 3xTF32 together), the plain version's time,
the library time of the same work
(:func:`same_work_call`: one ``torch.matmul`` of the stacked operands, TF32
off) and one ``torch.matmul`` at the same (M, K, N) as a rate beside it.
With no argument, ``mxu`` then ``main``:

- correctness on the first 256 of N frames (8192): the port's K1
  (ops/cuda_cnn.roi_cnn_fused) computes the JAX ``tiled3`` variant's
  function and is held against the plain CNN (the JAX ``grouped`` path,
  bitwise the plain convolutions) at K1's live bar 2e-4; ``wide`` and
  ``tiled`` compute the same function and have no separate counterpart:
  one row each says so;
- the timing rows: ``grouped`` f32 / bf16 as the plain CNN
  (``roi_cnn_plain``, ``roi_cnn_bf16_plain``), ``fused`` f32 / bf16 as K1
  and K1-bf16;
- the stage ablation through K1's ``debug_stop`` (conv1, conv2, conv3, then
  the full kernel): a stop compiles to other code than the full kernel, so
  its time is not a stage cost (the conv3 stop can outlast K1);
- the end-to-end live forward at B = N / 32, T = 32 through the port's
  ``live_forward``: ``grouped`` as ``roi_impl='plain'``, ``tiled3`` as the
  kernels, f32 and bf16. ``matmul_precision='parity'`` has no counterpart:
  the f32 rows run in f32 with TF32 off.

``ftile`` (``sweep_f_tile``): a K1 block takes one frame at a time, so
``f_tile`` has no counterpart: each (variant, f_tile) row says so, and K1 and the live
forward are timed once. A row's ``ms`` on the card is the device time of a
call with the host's launches held out (``proto_parity_cnn.device_ms``).
On the CPU (``device=cpu``) a run is a check of the code through the plain
versions, timed by the host clock, not a measurement; without a CUDA
device it raises unless ``device=cpu`` is given. Each part ends with one
JSON line.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..models.bigru import BiGRUClassifier, BiGRUConfig, init_params
from ..ops import cuda_cnn
from ..ops import cuda_mm_rate as mr
from . import proto_parity_cnn as harness

T = 32  # the live forward's clip length
BAR_CNN_LIVE = 2e-4  # K1 vs the plain CNN (tests/test_pallas_cnn2.py)
MXU_ITERS = 2  # timed calls a shape after the warm-up (the JAX probe: 1)
# the stacked operands of the library's same-work call, at most (else one
# grid step's call, timed and multiplied by grid)
SAME_WORK_BYTES = 16 * 2 ** 30
NO_COUNTERPART = ("the port's K1 computes this variant's function (one "
                  "kernel, tiled3): no separate counterpart")
NO_F_TILE = "a K1 block takes one frame at a time: f_tile has no counterpart"


def parse(argv: Sequence[str], what: str) -> harness.Args:
    return harness.parse_args(argv, what, n_step=T)


def note_row(name: str, note: str) -> dict:
    print(f"{name:>34s}: {note}", flush=True)
    return {"name": name, "ms": None, "note": note}


def same_work_call(a: torch.Tensor, b: torch.Tensor, reps: int, grid: int
                   ) -> tuple[Callable[[], torch.Tensor], int]:
    """One ``torch.matmul`` doing the probe's multiply-adds, for the
    library column (nothing in the port calls it): a's reps rolled copies
    side by side along K, b stacked reps times, (M, reps K) @ (reps K, N),
    which is one grid step's sum; all grid steps at once, (M, grid reps K)
    @ (grid reps K, N), where the stacked operands fit SAME_WORK_BYTES.
    Returns the call and the number of times it must run for the work
    (1, or grid where only one step's operands fit), the operands stacked
    here, before the call."""
    A = torch.cat([torch.roll(a, r % mr.ROLLS, dims=1)
                   for r in range(reps)], dim=1)
    B = b.repeat(reps, 1)
    calls = grid
    if 4 * grid * (A.numel() + B.numel()) <= SAME_WORK_BYTES:
        A, B, calls = A.repeat(1, grid), B.repeat(grid, 1), 1
    return (lambda: torch.matmul(A, B)), calls


def mxu_rate(M: int, K: int, N: int, args: harness.Args) -> dict:
    """mxu_rate (bench_fused_cnn.py:73): the kernel's T MAC/s at (M, K, N)
    over ``mr.REPS`` x ``mr.GRID`` products, its check against the plain
    version on the card, the share of the bound at 232 TFLOP/s (the f32
    FMAs and 3xTF32 together; a, b and out's bytes, which never bind), the
    plain version's
    time, the library's same-work time (:func:`same_work_call`; where it
    is one step's call, its time times grid, ``library_calls``) and
    torch.matmul's rate at (M, K, N)."""
    reps, grid = mr.REPS, mr.GRID
    a, b = mr.make_problem(M, K, N, args.device)
    macs = mr.macs(M, K, N, reps, grid)
    err = None
    if args.device.type == "cuda":
        err = mr.check(a, b, reps, grid)["max_abs_err"]
    few = args._replace(iters=min(args.iters, MXU_ITERS))
    ms = harness.timed_ms(lambda: mr.mm_rate(a, b, reps, grid), few)
    plain_ms = harness.timed_ms(lambda: mr.mm_rate_plain(a, b, reps, grid),
                                few)
    one_ms = harness.timed_ms(lambda: torch.matmul(a, b), args)
    call, calls = same_work_call(a, b, reps, grid)
    lib_ms = harness.timed_ms(call, few) * calls
    del call
    b_ms, b_by = harness.bound_ms(macs, 4 * (M * K + K * N + M * N),
                                  "f32_3xtf32")
    return {"ms": ms, "t_macs": macs / (ms * 1e-3) / 1e12,
            "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_calls": calls,
            "max_abs_err": err, "library_ms_one_matmul": one_ms,
            "library_t_macs": M * K * N / (one_ms * 1e-3) / 1e12}


def probe_mxu(argv: Optional[Sequence[str]] = None) -> dict:
    """probe_mxu (bench_fused_cnn.py:98): the six packed shapes."""
    args = parse(sys.argv[1:] if argv is None else argv, "bench_fused_cnn")
    print(f"== matmul rate probe (f32 in, f32 acc, reps={mr.REPS}, "
          f"grid={mr.GRID}) on {harness.device_name(args.device)} ==",
          flush=True)
    rows = []
    with torch.no_grad(), full_f32():
        for M, K, N, tag in mr.SHAPES:
            r = mxu_rate(M, K, N, args)
            print(f"  ({M:5d},{K:5d},{N:5d}) {tag:20s}: {r['t_macs']:7.2f} "
                  f"T MAC/s  {r['ms']:9.4f} ms, {r['bound_ms'] / r['ms']:6.1%}"
                  f" of its bound {r['bound_ms']:.4f} ms; plain "
                  f"{r['plain_ms']:.4f} ms; library (the same work) "
                  f"{r['library_ms']:.4f} ms"
                  + ("" if r["library_calls"] == 1 else
                     f" (one step's call x {r['library_calls']})")
                  + f"; torch.matmul {r['library_t_macs']:7.2f} T MAC/s",
                  flush=True)
            rows.append({"name": f"mxu_{M}x{K}x{N}", "tag": tag, **r})
    return harness.report("bench_fused_cnn mxu", args, rows, reps=mr.REPS,
                          grid=mr.GRID)


def _problem(args: harness.Args):
    """The JAX script's model (BiGRUConfig at x_dim 180, 10 classes, random
    from seed 0) and draws: frames from ``default_rng(0)``, then X."""
    cfg = BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    model = model.to(args.device).eval()
    with torch.no_grad():
        cnn = {k: {n: t.detach().clone() for n, t in v.items()}
               for k, v in model.params_tree()["roi_cnn"].items()}
    rng = np.random.default_rng(0)
    roi = torch.from_numpy(rng.integers(0, 256, (args.N, 48, 96),
                                        dtype=np.uint8)).to(args.device)
    B = args.N // T
    X = torch.from_numpy(rng.standard_normal((B, T, 180))
                         .astype(np.float32)).to(args.device)
    lengths = torch.full((B,), T, dtype=torch.int64, device=args.device)
    return model, cnn, roi, X, lengths, roi.reshape(B, T, 48, 96)


def _fwd(model, X, lengths, roi4, impl: str, dtype: str) -> Callable:
    return lambda: model.live_forward(X, lengths, roi4, roi_impl=impl,
                                      compute_dtype=dtype)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """main (bench_fused_cnn.py:125) on the port (module docstring)."""
    args = parse(sys.argv[1:] if argv is None else argv, "bench_fused_cnn")
    model, cnn, roi, X, lengths, roi4 = _problem(args)
    flat = cuda_cnn.flat_weights(cnn)
    flat16 = cuda_cnn.flat_weights_bf16(cnn)
    N, B = args.N, args.N // T
    print(f"bench_fused_cnn: N={N} frames of 48x96 on "
          f"{harness.device_name(args.device)}", flush=True)
    rows = []
    with torch.no_grad(), full_f32():
        head = roi[:256]
        want = cuda_cnn.roi_cnn_plain(head, cnn)
        err = harness.max_err(cuda_cnn.roi_cnn_fused(head, cnn, flat=flat),
                              want)
        harness.check("tiled3 (K1) vs grouped (the plain CNN)", err,
                      BAR_CNN_LIVE)
        for variant in ("wide", "tiled"):
            rows.append(note_row(f"correctness {variant}", NO_COUNTERPART))

        for name, fn in (
                ("grouped     f32", lambda: cuda_cnn.roi_cnn_plain(roi, cnn)),
                ("fused (K1)  f32", lambda: cuda_cnn.roi_cnn_fused(
                    roi, cnn, flat=flat)),
                ("grouped     bf16", lambda: cuda_cnn.roi_cnn_bf16_plain(
                    roi, cnn)),
                ("fused (K1)  bf16", lambda: cuda_cnn.roi_cnn_bf16(
                    roi, cnn, flat=flat16))):
            rows.append(harness.row(name, fn, args))
        for variant in ("fused-wide", "fused-tiled"):
            rows.append(note_row(f"{variant} f32/bf16", NO_COUNTERPART))

        print("== stage ablation through K1's debug stops (a stop compiles "
              "to other code than K1: not a stage cost) ==", flush=True)
        for stop in ("conv1", "conv2", "conv3", None):
            name = f"up to {stop or 'full'}"
            if stop is not None and args.device.type != "cuda":
                rows.append(note_row(name, "a stop of the CUDA kernel: not "
                                           "run on the cpu"))
                continue
            rows.append(harness.row(name, lambda stop=stop: (
                cuda_cnn.roi_cnn_fused(roi, cnn, flat=flat,
                                       debug_stop=stop)), args))

        print(f"== end-to-end live forward, B={B}, T={T} (f32 with TF32 "
              "off: matmul_precision='parity' has no counterpart) ==",
              flush=True)
        ref = model.live_forward(X, lengths, roi4, roi_impl="plain",
                                 gru_impl="plain")
        for impl, variant, dtype in (
                ("grouped", "-", "float32"), ("fused", "wide", "float32"),
                ("fused", "tiled", "float32"), ("fused", "tiled3", "float32"),
                ("grouped", "-", "bfloat16"), ("fused", "wide", "bfloat16"),
                ("fused", "tiled", "bfloat16"),
                ("fused", "tiled3", "bfloat16")):
            tag = "bf16" if dtype == "bfloat16" else "f32"
            name = f"e2e live fwd ({impl:7s}/{variant:5s} {tag:4s})"
            if variant in ("wide", "tiled"):
                rows.append(note_row(name, NO_COUNTERPART))
                continue
            fn = _fwd(model, X, lengths, roi4,
                      "plain" if impl == "grouped" else "auto", dtype)
            r = harness.row(name, fn, args, harness.max_err(fn(), ref))
            r["clips_s"] = B / (r["ms"] * 1e-3)
            print(f"{'':>34s}  -> {r['clips_s']:.0f} clips/s", flush=True)
            rows.append(r)
    return harness.report("bench_fused_cnn", args, rows)


def sweep_f_tile(argv: Optional[Sequence[str]] = None) -> dict:
    """sweep_f_tile (bench_fused_cnn.py:216) on the port (module
    docstring): the f_tile rows say why they have no counterpart; K1 and
    the live forward are timed once."""
    args = parse(sys.argv[1:] if argv is None else argv, "bench_fused_cnn")
    model, cnn, roi, X, lengths, roi4 = _problem(args)
    flat = cuda_cnn.flat_weights(cnn)
    rows = []
    with torch.no_grad(), full_f32():
        for variant in ("tiled3", "tiled", "wide"):
            for f_tile in (8, 16, 32, 64):
                rows.append(note_row(
                    f"standalone {variant:5s} f_tile={f_tile:3d}", NO_F_TILE))
        err = harness.max_err(cuda_cnn.roi_cnn_fused(roi[:256], cnn,
                                                     flat=flat),
                              cuda_cnn.roi_cnn_plain(roi[:256], cnn))
        harness.check("K1 vs the plain CNN", err, BAR_CNN_LIVE)
        rows.append(harness.row("standalone K1 (a frame at a time a block)",
                                lambda: cuda_cnn.roi_cnn_fused(roi, cnn,
                                                               flat=flat),
                                args, err))
        for f_tile in (16, 32, 64):
            rows.append(note_row(f"e2e tiled f_tile={f_tile:3d}", NO_F_TILE))
        rows.append(harness.row("e2e live fwd (K1)", _fwd(
            model, X, lengths, roi4, "auto", "float32"), args))
    return harness.report("bench_fused_cnn ftile", args, rows)


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["mxu"]:
        probe_mxu(argv[1:])
    elif argv[:1] == ["ftile"]:
        sweep_f_tile(argv[1:])
    else:
        probe_mxu(argv)
        main(argv)
