"""GRU micro-benchmark on the card: the plain scan against the GRU sequence
kernel K2 (port of scripts/bench_gru.py), for the model-shaped stack (2
bidirectional layers, H=192, D=180) and for one direction.

    python -m silent_speech_tpu_torch.scripts.bench_gru [B] [T] \\
        [device=cuda] [iters=100]

Also the harness of the GRU probes (proto_gru2, proto_gru3, proto_gru4):
the problem drawn as the JAX scripts draw it (``np.random.default_rng(0)``,
weights ``standard_normal * 0.05``, zero biases, x and lengths in
``[T // 2, T]``), the baselines every probe's table starts with, the timer
(CUDA events after warm-up on the card; the host clock on the CPU, where
the run is a check of the code, not a measurement), the rows and the JSON
line. A run with no CUDA device raises unless ``device=cpu`` is given.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..infer.predictor import full_f32
from ..ops import cuda_gru
from ..ops import gru as gru_ops

ITERS = 100
WARMUP = 3
H, D, LAYERS = 192, 180, 2


class Args(NamedTuple):
    B: int
    T: int
    device: torch.device
    iters: int


class Problem(NamedTuple):
    x: torch.Tensor  # (B, T, D) f32
    lengths: torch.Tensor  # (B,) int64, on the device
    layers: list  # [{'fwd': {wi, wh, bi, bh}, 'bwd': {...}}] * LAYERS


def parse_args(argv: Sequence[str]) -> Args:
    """``[B] [T] [device=cuda] [iters=100]``."""
    pos = [a for a in argv if "=" not in a]
    kw = dict(a.split("=", 1) for a in argv if "=" in a)
    unknown = set(kw) - {"device", "iters"}
    if len(pos) > 2 or unknown:
        raise SystemExit("usage: [B] [T] [device=cuda|cpu] [iters=N]")
    device = torch.device(kw.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the GRU probes measure the card; pass "
            "device=cpu to run the plain versions on the CPU")
    return Args(int(pos[0]) if pos else 512,
                int(pos[1]) if len(pos) > 1 else 32, device,
                int(kw.get("iters", ITERS)))


def make_problem(B: int, T: int, device: torch.device) -> Problem:
    """The JAX scripts' draws, in their order."""
    rng = np.random.default_rng(0)

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * np.float32(0.05)).to(device)

    def dir_params(d):
        p = {"wi": normal((d, 3 * H)), "wh": normal((H, 3 * H))}
        p["bi"] = torch.zeros(3 * H, device=device)
        p["bh"] = torch.zeros(3 * H, device=device)
        return p

    layers, d = [], D
    for _ in range(LAYERS):
        layers.append({"fwd": dir_params(d), "bwd": dir_params(d)})
        d = 2 * H
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(T // 2, T + 1, (B,)))
    return Problem(x.to(device), lengths.to(device), layers)


def scan_stack(pb: Problem) -> torch.Tensor:
    """The plain masked scan (ops/gru.py), the reference of every row."""
    return gru_ops.bigru(pb.x, pb.lengths, pb.layers)[0]


def baselines(pb: Problem) -> list[tuple[str, Callable]]:
    """The rows every probe's stack table starts with: the plain scan and
    K2 (two launches a layer, gru_proj and gru_seq, both directions in
    each, the reverse in the recurrence), its weights packed once before
    the calls, as the model keeps them (``kernel_weights``)."""
    packed = [dict(lp, packed=cuda_gru.pack_layer(
        [(lp["fwd"], False), (lp["bwd"], True)])) for lp in pb.layers]
    return [("scan", lambda: scan_stack(pb)),
            ("K2 bigru_kernel", lambda: cuda_gru.bigru_kernel(
                pb.x, pb.lengths, packed))]


def one_direction_baselines(pb: Problem) -> list[tuple[str, Callable]]:
    """The rows of the one-direction tables: the scan and K2's launch for
    the first layer's forward direction."""
    p = pb.layers[0]["fwd"]
    return [("scan", lambda: gru_ops.gru_layer_single_direction(
                pb.x, pb.lengths, p)[0]),
            ("K2 gru_sequence", lambda: cuda_gru.gru_layer(
                pb.x, pb.lengths, p))]


def time_ms(fn: Callable, iters: int, device: torch.device) -> float:
    """Mean ms per call after WARMUP calls: CUDA events on the card, the
    host clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run_table(title: str, variants: list[tuple[str, Callable]],
              y_ref: torch.Tensor, args: Args) -> list[dict]:
    """One row a variant: ms, speedup over the first row, max abs error
    against ``y_ref``. A variant that fails raises."""
    print(f"[{title}]", flush=True)
    rows, base = [], None
    for name, fn in variants:
        err = (fn() - y_ref).abs().max().item() if y_ref.numel() else 0.0
        ms = time_ms(fn, args.iters, args.device)
        base = base or ms
        print(f"{name:>28s}: {ms:9.4f} ms  {base / ms:5.2f}x  "
              f"err={err:.2e}", flush=True)
        rows.append({"table": title, "name": name, "ms": ms,
                     "speedup_vs_first": base / ms, "max_abs_err": err})
    return rows


def header(args: Args) -> None:
    print(f"B={args.B} T={args.T} H={H} D={D} layers={LAYERS} "
          f"bidirectional on {device_name(args.device)}", flush=True)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def report(script: str, args: Args, rows: list[dict]) -> dict:
    """Print and return the run's JSON line."""
    out = {"script": script, "device": device_name(args.device),
           "timer": "cuda events" if args.device.type == "cuda"
           else "host clock (cpu: not a device measurement)",
           "B": args.B, "T": args.T, "H": H, "D": D, "layers": LAYERS,
           "iters": args.iters, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    pb = make_problem(args.B, args.T, args.device)
    header(args)
    with torch.no_grad(), full_f32():
        y_ref = scan_stack(pb)
        rows = run_table("stack", baselines(pb), y_ref, args)
        base1 = one_direction_baselines(pb)
        rows += run_table("one direction", base1, base1[0][1](), args)
    return report("bench_gru", args, rows)


if __name__ == "__main__":
    main()
