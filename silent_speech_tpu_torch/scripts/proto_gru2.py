"""Probe: a GRU recurrence kernel over a projection hoisted out of it, with
the two directions of a layer stacked along the batch (port of
scripts/proto_gru2.py).

    python -m silent_speech_tpu_torch.scripts.proto_gru2 [B] [T] \\
        [device=cuda] [iters=100]

The projection ``xp = x Wi + bi`` is a ``torch.einsum`` outside the kernel,
as the JAX script computes it with ``jnp.einsum`` outside its
``pallas_call``; the forward and the backward direction (of the flipped
input) are stacked into one (2B, T, 3H) launch of the recurrence kernel
(csrc/gru_proto.cu, on K2's cluster recurrence) with two weight sets.
``bf16_mm`` rounds h and Wh for the recurrent product.

The variant tables sweep the card's knob ``batch_tile`` (rows a
thread-block cluster; by default the kernel's plan). The one-direction
table runs ``gru_sequence_kstep`` (one weight set) against the scan and
K2.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from ..infer.predictor import full_f32
from ..ops.cuda_gru_proto import gru_sequence_kstep, gru_sequence_kstep_2w
from ..ops.gru import flip_padded
from . import bench_gru as harness

__all__ = ["gru_sequence_kstep", "gru_sequence_kstep_2w", "bigru_fused",
           "main"]


def _proj(x: torch.Tensor, p: dict) -> torch.Tensor:
    return torch.einsum("btd,dh->bth", x, p["wi"]) + p["bi"]


def bigru_fused(x: torch.Tensor, lengths: torch.Tensor, layers: list, *,
                batch_tile: Optional[int] = None, k_steps: int = 8,
                bf16_mm: bool = False,
                impl: str = "auto") -> torch.Tensor:
    """Stacked biGRU, one recurrence launch a layer: the directions stacked
    along the batch (proto_gru2.py::bigru_fused). Returns (B, T, 2H)."""
    out = x
    B = x.shape[0]
    for lp in layers:
        xp2 = torch.cat([_proj(out, lp["fwd"]),
                         _proj(flip_padded(out, lengths), lp["bwd"])])
        y2 = gru_sequence_kstep_2w(
            xp2, torch.cat([lengths, lengths]),
            torch.stack([lp["fwd"]["wh"], lp["bwd"]["wh"]]),
            torch.stack([lp["fwd"]["bh"], lp["bwd"]["bh"]]),
            batch_tile=batch_tile, k_steps=k_steps, bf16_mm=bf16_mm,
            impl=impl)
        out = torch.cat([y2[:B], flip_padded(y2[B:], lengths)], dim=-1)
    return out


# (name, knobs) of the stack table; each fits a block's shared memory at
# H=192 (ops/cuda_gru_proto.rec_geometry); no batch_tile: the kernel's
# plan (one wave where a tile gives one)
STACK_VARIANTS = [
    ("fused plan", {}),
    ("fused bt1", {"batch_tile": 1}),
    ("fused bt4", {"batch_tile": 4}),
    ("fused bt16", {"batch_tile": 16}),
    ("fused bt32", {"batch_tile": 32}),
    ("fused bt64", {"batch_tile": 64}),
    ("fused plan bf16mm", {"bf16_mm": True}),
    ("fused bt2 bf16mm", {"batch_tile": 2, "bf16_mm": True}),
]
ONE_DIRECTION_VARIANTS = [
    ("kstep plan", {}),
    ("kstep bt8", {"batch_tile": 8}),
    ("kstep bt1", {"batch_tile": 1}),
    ("kstep plan bf16mm", {"bf16_mm": True}),
]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = harness.parse_args(sys.argv[1:] if argv is None else argv)
    pb = harness.make_problem(args.B, args.T, args.device)
    harness.header(args)
    x, L, layers = pb
    p = layers[0]["fwd"]
    with torch.no_grad(), full_f32():
        stack = harness.baselines(pb) + [
            (name, lambda kw=kw: bigru_fused(x, L, layers, **kw))
            for name, kw in STACK_VARIANTS]
        rows = harness.run_table("stack", stack, harness.scan_stack(pb),
                                 args)
        one = harness.one_direction_baselines(pb) + [
            (name, lambda kw=kw: gru_sequence_kstep(
                _proj(x, p), L, p["wh"], p["bh"], **kw))
            for name, kw in ONE_DIRECTION_VARIANTS]
        rows += harness.run_table("one direction", one, one[0][1](), args)
    return harness.report("proto_gru2", args, rows)


if __name__ == "__main__":
    main()
