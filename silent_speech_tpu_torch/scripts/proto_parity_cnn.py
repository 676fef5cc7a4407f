"""Probe: the parity-packed fused conv1 + pool1 kernel on the card (port of
scripts/proto_parity_cnn.py).

    python -m silent_speech_tpu_torch.scripts.proto_parity_cnn [N] \\
        [device=cuda] [iters=30]

The frames come split into the four row classes h mod 4, so the 2x2 pool
is a max over class pairs, and conv1's weights are packed per w-parity into
two (104, 128) matrices, so the w-direction pool is a max over the two
products (ops/cuda_parity_cnn.py, csrc/roi_parity.cu). The rows: the plain
conv1 + pool1 on the card (conv, ReLU, max pool; the counterpart of the
script's "XLA conv1+pool1 reference"), the kernel on pre-split classes and
the kernel with the ``roi[:, c::4]`` split included, each with the stack
into (N, 24, 48, 8) (``pooled1_from_quadrants``) and its max abs error
against the plain conv1 + pool1, which must stay under 1e-4 (the script's
f32 bar, :223). A row's ``ms`` is, on the card, the device time of a call
with the host's launches held out (:func:`device_ms`).

Also the harness of the CNN-front probes (proto_parity_e2e, proto_ablate,
probe_front): the arguments (N frames, 8192 by default, the scripts'
problem; a multiple of 16), the rows and the JSON line. On the CPU
(``device=cpu``) a run is a check of the code at a small N, timed by the
host clock, not a measurement; without a CUDA device it raises unless
``device=cpu`` is given.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..ops import cuda_parity_cnn as pc
from .bench_gru import device_name, time_ms

N_FRAMES = 8192
ITERS = 30
TOL = 1e-4  # proto_parity_cnn.py:223 and proto_parity_e2e.py:165, f32
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit), the rate
# probes' bounds: operations a second by type (an FMA or a multiply-add is
# two), and HBM bytes a second; "f32_3xtf32": f32 work that may run on the
# FMAs (67 TFLOP/s) and as 3xTF32 on the tensor cores (three TF32 products a
# multiply-add, 495 / 3) at once, the rate of the backward dots' tt and nn
PEAK_OPS = {"f32": 67e12, "f32_3xtf32": 67e12 + 495e12 / 3, "bf16": 989e12,
            "int8": 1979e12}
PEAK_BYTES_S = 3.35e12


def bound_ms(macs: float, nbytes: float, kind: str = "f32"
             ) -> tuple[float, str]:
    """The least time for the work on the card, and what sets it: the
    larger of 2 * macs over the peak for ``kind`` (a key of PEAK_OPS) and
    the bytes over the memory rate."""
    t_ops = 2 * macs / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Args(NamedTuple):
    N: int
    device: torch.device
    iters: int


def parse_args(argv: Sequence[str], what: str, n_default: int = N_FRAMES,
               n_step: int = pc.F_STEP, iters_default: int = ITERS) -> Args:
    """``[N] [device=cuda] [iters=30]``: N frames (or the script's own
    count, ``n_default``), a positive multiple of ``n_step``."""
    pos = [a for a in argv if "=" not in a]
    kw = dict(a.split("=", 1) for a in argv if "=" in a)
    if len(pos) > 1 or set(kw) - {"device", "iters"}:
        raise SystemExit("usage: [N] [device=cuda|cpu] [iters=N]")
    device = torch.device(kw.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: {what} measures the card; pass device=cpu to "
            "run the plain versions on the CPU")
    N = int(pos[0]) if pos else n_default
    if N < n_step or N % n_step:
        raise SystemExit(f"N={N}: a positive multiple of {n_step}")
    return Args(N, device, int(kw.get("iters", iters_default)))


def header(args: Args, what: str) -> None:
    print(f"{what}: N={args.N} frames of 48x96 on "
          f"{device_name(args.device)}", flush=True)


# cycles of the spin kernel that holds the stream while the host enqueues
# a timed run (about 25 ms on the H100): longer than the host takes to
# launch ``iters`` calls
HOLD_CYCLES = 50_000_000
FLUSH_BYTES = 128 << 20  # over 2.5x the H100's 50 MB L2


def _held_ms(fn: Callable, args: Args) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize(args.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(args.iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / args.iters


def device_ms(fn: Callable, args: Args, cold: bool = False
              ) -> Optional[float]:
    """Mean device ms a call of ``fn``, ``args.iters`` calls back to back on
    the card: a spin kernel holds the stream while the host enqueues them,
    so the CUDA events between the calls time the card alone, not the
    host's launches (which outlast a kernel of tens of microseconds).
    ``cold``: each call after a 128 MB write that evicts the L2, whose own
    time is subtracted: the inputs come from device memory, as for a caller
    that has not just touched them. None on the CPU."""
    if args.device.type != "cuda":
        return None
    if not cold:
        return _held_ms(fn, args)
    flush = torch.empty(FLUSH_BYTES // 4, device=args.device).zero_
    return _held_ms(lambda: (flush(), fn()), args) - _held_ms(flush, args)


def timed_ms(fn: Callable, args: Args, cold: bool = False) -> float:
    """A call's ms: on the card its device time (:func:`device_ms`), on
    the CPU the host clock (a check of the code, not a measurement)."""
    if args.device.type == "cuda":
        return device_ms(fn, args, cold)
    return time_ms(fn, args.iters, args.device)


def row(name: str, fn: Callable, args: Args, err: Optional[float] = None,
        cold: bool = False) -> dict:
    """Time ``fn`` and print one row. ``ms``: on the card the device time of
    a call (:func:`device_ms`; ``cold``: the L2 evicted before each call,
    for a row bound by the bytes from device memory), on the CPU the host
    clock (a check of the code, not a measurement). ``err`` is its error
    against the table's reference (None: not compared)."""
    ms = timed_ms(fn, args, cold)
    tail = "" if err is None else f"  err={err:.2e}"
    print(f"{name:>34s}: {ms:9.4f} ms{tail}", flush=True)
    return {"name": name, "ms": ms, "max_abs_err": err}


def max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return (got.double() - ref.double()).abs().max().item()


def check(name: str, err: float, tol: float) -> None:
    print(f"correctness {name}: max|err| = {err:.2e} (tol {tol:g})",
          flush=True)
    if not err <= tol:
        raise RuntimeError(f"{name}: max|err| {err:.3e} over the bar {tol:g}")


def report(script: str, args: Args, rows: list[dict], **extra) -> dict:
    """Print and return the run's JSON line."""
    out = {"script": script, "device": device_name(args.device),
           "timer": "cuda events" if args.device.type == "cuda"
           else "host clock (cpu: not a device measurement)",
           "N": args.N, "iters": args.iters, **extra, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


def make_problem(N: int, device: torch.device):
    """The JAX script's draws (``default_rng(0)``): frames, conv1's k
    (standard_normal * 0.3) and b (* 0.1)."""
    rng = np.random.default_rng(0)
    roi = rng.integers(0, 256, (N, 48, 96), dtype=np.uint8)
    k = rng.standard_normal((3, 3, 1, 8)).astype(np.float32) * 0.3
    b = rng.standard_normal(8).astype(np.float32) * 0.1
    WE, WO, bias = pc.pack_parity_conv1(k, b)
    to = lambda a: torch.as_tensor(a).to(device)
    return to(roi), to(k), to(b), to(WE), to(WO), to(bias)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv,
                      "proto_parity_cnn")
    N = args.N
    roi, k, b, WE, WO, bias = make_problem(N, args.device)
    header(args, "proto_parity_cnn")
    xs = pc.split_classes(roi)

    def fused():
        return pc.pooled1_from_quadrants(
            pc.conv1pool1_parity(*xs, WE, WO, bias), N)

    def split_then_fused():
        return pc.pooled1_from_quadrants(
            pc.conv1pool1_parity(*pc.split_classes(roi), WE, WO, bias), N)

    with torch.no_grad(), full_f32():
        want = pc.ref_conv1pool1(roi, k, b)
        err = max_err(fused(), want)
        check("parity kernel vs plain conv1+pool1", err, TOL)
        rows = [row("plain conv1+pool1 (reference)",
                    lambda: pc.ref_conv1pool1(roi, k, b), args),
                row("parity kernel (pre-split)", fused, args, err),
                row("parity kernel (incl split)", split_then_fused, args,
                    max_err(split_then_fused(), want))]
    return report("proto_parity_cnn", args, rows, tol=TOL)


if __name__ == "__main__":
    main()
